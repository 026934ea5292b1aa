"""Plain references the benchmark holds the program to.  They import
neither ``jax`` nor the JAX package nor anything of the program, and work
out everything from the inputs the benchmark made.

A configuration names its model's reference by its ``"reference"`` key:
``reference/<name>.py``, loaded by file.  The drivers and the yardstick
take from it, and from nothing else:

- ``shapes(m)``: the weight tree, ``{name: shape or subtree}``, in the
  order its leaves are drawn;
- ``init(m, path)``: how a leaf is made: its normal draw's std, or
  ``"ones"``, ``"zeros"``, ``"A_log"``, ``"dt_bias"``;
- ``keeps_f32(path)``: a leaf served in float32 whatever the dtype;
- ``param_count(m, active_only)``: the parameters, or those active per
  token, that the model FLOPs count;
- ``logits_at(params, m, tokens, first, mm=)``, ``loss(params, m, batch,
  mm=, routing=)``, ``Routing``, ``moe_layer_keys(m)``;
- the products ``mm_f32`` (the reference's own), ``mm_bf16`` and
  ``mm_fp8`` (the control's).

``adamw.py`` is the optimizer every training cell's reference steps with.
"""
