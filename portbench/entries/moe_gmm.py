"""``ops.moe_gmm_ffn(xs, group_sizes, w_gate, w_up, w_down)``: the routed
rows, the expert FFN's width in and out, and the group sizes (a tensor on
the device, read once the window has closed)."""


def record(a, k, out):
    return (a[0].shape[0], a[2].shape[1], a[2].shape[2], a[1])
