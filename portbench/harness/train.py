"""Training cells: the port's train step under the launcher's loop, with
BigRoots diagnosing every step.

Set-up builds one train state from the seed's weights, the loop's data
feed (the program's prefetcher over the benchmark's token batches), its
telemetry and its diagnosis, and drives the loop's own step through its
first steps, recording the experts step 1 routed each token to.  The
window then runs that same loop until ``seconds`` have passed and the
step started last has finished.  Afterwards the configuration's plain
reference follows the first steps from the same weights and batches, and
takes step 1 once more routed as the program routed it.
"""
from __future__ import annotations

import math
import statistics
import time

import torch

from ..reference import adamw as ref_adamw
from ..traffic import tokens as token_traffic
from ..yardstick import work
from . import common, weights
from .common import port_config
from .spans import Spans

#: The program's entries a training cell traces where its configuration
#: lists none: the expert FFN (K5).
ENTRIES = [{"entry": "moe_gmm_ffn", "span": "moe_gmm"}]


class TrainCell:
    """One training cell.  ``model`` overrides widths for tests on the
    host; ``fault`` plants a fault under the timed path (tests and
    calibration): ``"unchanged"`` (the step hands back its input state) or
    ``"half_batch"`` (each batch cut to its first half)."""

    def __init__(self, cell: dict, seed: int, device: torch.device, *,
                 model: dict | None = None, fault: str | None = None,
                 port_over: dict | None = None) -> None:
        self.cell = cell
        self.wl = cell["workload"]
        self.m = dict(cell["config"]["model"], **(model or {}))
        self.ref = common.reference(cell["config"])
        self.entries = cell["config"].get("entries", ENTRIES)
        self.seed = seed % (1 << 63)
        self.device = device
        self.fault = fault
        self.port_over = port_over or {}
        self.spans = Spans(device, events=False)
        self.records: dict = {"losses": [], "failed": 0}

    # -- set-up ---------------------------------------------------------------
    def setup(self) -> None:
        from repro_torch.core import BigRootsAnalyzer, JAX_FEATURES
        from repro_torch.data.pipeline import Prefetcher
        from repro_torch.models import Model
        from repro_torch.serve import Diagnosis, FleetAggregator
        from repro_torch.telemetry.events import GcTimer, StepTelemetry
        from repro_torch.telemetry.sampler import SystemSampler
        from repro_torch.telemetry.timeline import ResourceTimeline
        from repro_torch.train.optimizer import AdamWConfig, adamw_init
        from repro_torch.train.step import make_train_step

        wl, m, dev = self.wl, self.m, self.device
        self.times = {}
        t = time.perf_counter()
        self.B, self.S = wl["batch"], wl["seq"]
        cfg = port_config(m, **self.port_over)
        self.opt_cfg = AdamWConfig()
        params = weights.make(self.ref, m, self.seed, dev, torch.float32)
        self.state = {"params": params, "opt": adamw_init(params)}
        step = make_train_step(Model(cfg), self.opt_cfg)
        if self.fault == "unchanged":
            def step_fn(state, batch, _step=step):
                return state, _step(state, batch)[1]
        else:
            step_fn = step
        self.step_fn = step_fn
        rows = self.B // 2 if self.fault == "half_batch" else None
        loader = token_traffic.TokenLoader(self.seed, self.B, self.S,
                                           m["vocab"], rows=rows)
        self.prefetch = Prefetcher(loader, depth=2)
        self.timeline = ResourceTimeline()
        self.sampler = SystemSampler("host0", self.timeline,
                                     interval=0.25).start()
        self.gc_timer = GcTimer().install()
        self.telem = StepTelemetry("host0", timeline=self.timeline,
                                   window=wl["window_steps"],
                                   gc_timer=self.gc_timer, wire=True)
        # The launcher's single-host diagnosis: a fleet of one, its own
        # rows only.
        analyzer = BigRootsAnalyzer(JAX_FEATURES, timelines=self.timeline,
                                    device=dev)
        self.agg = FleetAggregator(JAX_FEATURES, analyzer, max_rows=None,
                                   max_stages=wl["max_stages"], device=dev)
        self.diag = Diagnosis.fleet(self.agg)
        self.spans.wrap(self.agg, "ingest_host", "diag_ingest")
        self.step_no = wl["first_step"]
        self.times["build"] = time.perf_counter() - t
        self._warm()

    def one_step(self) -> float:
        """The launcher's loop body: fetch, upload, step, then the
        diagnosis tick.  Returns the step's loss."""
        sp, dev = self.spans, self.device
        t0 = time.time()
        with self.telem.step(self.step_no) as scope:
            with scope.phase("data_load"), sp.span("data_wait"):
                batch_np, meta = self.prefetch.next()
            scope.add("read_bytes", meta.read_bytes)
            scope.set_locality(meta.locality)
            with scope.phase("h2d"):
                batch = {k: torch.from_numpy(v).to(dev)
                         for k, v in batch_np.items()}
            with scope.phase("compute"), sp.span("train_step"), \
                    sp.device_span("train_step"):
                self.state, metrics = self.step_fn(self.state, batch)
                loss = float(metrics["loss"])
        with sp.span("diag_tick"):
            self.diag.tick(self.telem, step_time=time.time() - t0)
            if dev.type == "cuda":
                torch.cuda.synchronize()
        self.step_no += 1
        return loss

    def _warm(self) -> None:
        """The loop's first steps, which the reference follows: step 1's
        routing and gradient as the optimizer holds it, the losses, and
        the change of the parameters after the last of them."""
        from repro_torch.models.moe import routing_hook

        n = self.wl["check"]["reference_steps"]
        b1 = self.opt_cfg.b1
        for k in range(n):
            t = time.perf_counter()
            if k == 0:
                # Each router call's top-k experts, as chosen; a forward
                # pass reaches the MoE layers in order, before the
                # backward's recomputation calls them again.
                seen: list = []
                with routing_hook(lambda probs, experts:
                                  seen.append(experts) or experts):
                    loss = self.one_step()
                self.records["routes"] = dict(
                    zip(self.ref.moe_layer_keys(self.m), seen))
            else:
                loss = self.one_step()
            self.times[f"step{k + 1}"] = time.perf_counter() - t
            self.records["losses"].append(loss)
            if k == 0:
                # Adam's first moment after one step is (1 - b1) times
                # the clipped gradient the optimizer was given.
                m = weights.flat(self.state["opt"].m)
                self.records["grad_norms"] = dict(zip(m, (torch.stack(
                    [v.norm() for v in m.values()]) / (1 - b1)).tolist()))
                self.records["grads1"] = {p: v.cpu() / (1 - b1)
                                          for p, v in m.items()}
                del m
        p0 = weights.flat(weights.make(self.ref, self.m, self.seed,
                                       self.device, torch.float32))
        p3 = weights.flat(self.state["params"])
        self.records["change_norms"] = dict(zip(p0, torch.stack(
            [(p3[k].float() - p0[k]).norm() for k in p0]).tolist()))
        del p0, p3
        if self.dev_is_cuda:
            torch.cuda.synchronize()
        self.one_step()

    @property
    def dev_is_cuda(self) -> bool:
        return self.device.type == "cuda"

    # -- the window -------------------------------------------------------------
    def trace_entries(self) -> None:
        """Device spans around the program's public entries, and the
        shapes each call was given (traced runs)."""
        self.spans.events = self.dev_is_cuda
        common.trace_entries(self.spans, self.entries)

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        attempted = 0
        while time.perf_counter() - t0 < seconds:
            attempted += 1
            try:
                loss = self.one_step()
            except Exception:
                self.records["failed"] += 1
                raise
            if not math.isfinite(loss):
                self.records["failed"] += 1
        if self.dev_is_cuda:
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        self.window_steps = attempted
        self.window_t = (t0, t1)
        return {"t0": t0, "t1": t1, "attempted": attempted,
                "failed": self.records["failed"]}

    def window_info(self) -> dict:
        """The window's steps on the host clock: each step's train step and
        diagnosis tick, in ms (rounded; information, not compared)."""
        if not hasattr(self, "window_t"):
            return {}
        t0, t1 = self.window_t
        return {name: [round((b - a) * 1e3) for n, a, b in self.spans.host
                       if n == name and t0 <= a <= t1]
                for name in ("train_step", "diag_tick")}

    def close(self) -> None:
        self.spans.restore()
        self.prefetch.stop()
        self.sampler.stop()
        self.gc_timer.uninstall()

    def free(self) -> None:
        self.state = None
        self.step_fn = None
        if self.dev_is_cuda:
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- metrics ------------------------------------------------------------------
    def end_to_end(self, w: dict) -> dict:
        tokens = self.window_steps * self.B * self.S
        return {"train_tokens_per_s": tokens / (w["t1"] - w["t0"])}

    def layer_context(self, w: dict) -> dict:
        return {"tokens": self.window_steps * self.B * self.S,
                **common.entry_context(self.spans, self.entries),
                "step_ms": self.spans.device_ms("train_step"),
                "active_params": work.active_params(self.ref, self.m),
                "model": self.m}

    # -- correctness ----------------------------------------------------------------
    def _batch(self, step: int) -> dict:
        b = token_traffic.batch_at(self.seed, step, self.B, self.S,
                                   self.m["vocab"])
        return {k: torch.from_numpy(v).to(self.device) for k, v in b.items()}

    def _params(self) -> dict:
        p = weights.flat(weights.make(self.ref, self.m, self.seed,
                                      self.device, torch.float32))
        for v in p.values():
            v.requires_grad_(True)
        return p

    def reference(self, mm=None) -> dict:
        """The plain reference's first steps from the same weights and
        batches: the losses, step 1's routing and clipped gradient, and
        the change of the parameters after the last step, each leaf's norm
        (``mm``: the products, the reference's float32 ``mm_f32`` or a
        control's)."""
        m, mm = self.m, mm or self.ref.mm_f32
        t0 = time.perf_counter()
        n = self.wl["check"]["reference_steps"]
        p = self._params()
        p0 = {k: v.detach().clone() for k, v in p.items()}
        opt = ref_adamw.AdamWRun(ref_adamw.AdamW(), p)
        out: dict = {"losses": []}
        for k in range(n):
            routing = self.ref.Routing() if k == 0 else None
            loss = self.ref.loss(weights.unflat(p), m, self._batch(k),
                                 mm=mm, routing=routing)
            grads = torch.autograd.grad(loss, list(p.values()))
            out["losses"].append(float(loss.detach()))
            clipped = opt.update(p, dict(zip(p, grads)))
            if k == 0:
                out["routes"] = routing.chosen
                out["grads1"] = clipped
                out["grad_norms"] = _norms(clipped)
            del grads, clipped
        out["change_norms"] = _norms({k: p[k].detach() - p0[k] for k in p})
        out["seconds"] = time.perf_counter() - t0
        return out

    def routed_step(self, routes: dict | None) -> dict | None:
        """Step 1 of the plain reference in float32, each MoE layer routed
        to ``routes`` (the top-k experts by layer of the run judged): the
        loss, the clipped gradient and each leaf's norm, and every routed
        slot's logit gap below the reference's own k-th best.  ``None``
        where ``routes`` does not route this step's every token in every
        MoE layer."""
        keys = self.ref.moe_layer_keys(self.m)
        rows = self.B * self.S
        if not routes or any(k not in routes or routes[k].shape[0] != rows
                             for k in keys):
            return None
        t0 = time.perf_counter()
        p = self._params()
        routing = self.ref.Routing(forced=routes)
        loss = self.ref.loss(weights.unflat(p), self.m, self._batch(0),
                             routing=routing)
        grads = torch.autograd.grad(loss, list(p.values()))
        clipped = ref_adamw.clip(dict(zip(p, grads)), ref_adamw.AdamW())
        del grads, p
        return {"loss": float(loss.detach()), "grads1": clipped,
                "grad_norms": _norms(clipped),
                "outside": torch.cat([routing.outside[k].flatten()
                                      for k in keys]),
                "seconds": time.perf_counter() - t0}

    def check(self) -> list[dict]:
        """The numbers compared, each beside its limit (those the
        workload's ``limits`` name)."""
        lim = self.wl["limits"]
        ref = self.reference()
        got = numbers(self.records, ref)
        ref_s = ref["seconds"]
        del ref
        routed = self.routed_step(self.records.get("routes"))
        got.update(routed_numbers(self.records, routed))
        self.info = {k: got[k] for k in got if k not in lim}
        self.info.update(reference_s=ref_s + (routed or {}).get("seconds", 0),
                         **self.window_info())
        return [{"name": k, "value": _finite(got[k]), "limit": v}
                for k, v in lim.items()]


#: A row of the embedding gradient counts as touched by the batch above
#: this share of the largest row's norm.
ROW_TOUCHED = 0.01


def _norms(leaves: dict) -> dict:
    return dict(zip(leaves, torch.stack(
        [v.float().norm() for v in leaves.values()]).tolist()))


def numbers(got: dict, ref: dict) -> dict:
    """The program's first steps against the reference's: the loss's
    relative gap (the worst step); by the worst leaf, the gap between the
    norms of step 1's clipped gradient and the gap between the norms of
    the parameters' change after the last step; the norm of the
    difference of step 1's clipped gradients, by the median leaf and by
    the worst; each over the larger of the reference leaf's norm and the
    median leaf's.  Leaves whose reference gradient is under a thousandth
    of the median leaf's move by round-off alone: they are left out of
    the change.  Beside them, the embedding rows the step's tokens touched:
    rows of step 1's embedding gradient above ``ROW_TOUCHED`` of the
    largest row (the tokens and labels of the batch; every other row gets
    only the head's softmax share, thousands of times smaller), the
    program's count against the reference's."""
    loss = max(abs(a - b) / abs(b) for a, b in
               zip(got["losses"], ref["losses"]))
    g_ref = ref["grad_norms"]
    g_med = statistics.median(g_ref.values())
    grad = _leaf_gaps(got["grad_norms"], g_ref)
    diff = _leaf_diffs(got["grads1"], ref["grads1"], g_ref)
    touched = {}
    for who, grads in (("got", got["grads1"]), ("ref", ref["grads1"])):
        rows = grads["embed"].to(ref["grads1"]["embed"].device).float()
        norms = rows.norm(dim=1)
        touched[who] = int((norms > ROW_TOUCHED * norms.max()).sum())
    counted = [k for k, v in g_ref.items() if v >= 1e-3 * g_med]
    c_ref = ref["change_norms"]
    change = _leaf_gaps({k: got["change_norms"][k] for k in counted},
                        {k: c_ref[k] for k in counted})
    return {"loss_gap": loss,
            "rows_touched_gap": abs(touched["got"] - touched["ref"])
            / max(touched["ref"], 1),
            "rows_touched": touched,
            "grad_leaf_gap": max(grad.values()),
            "grad_diff_median": statistics.median(diff.values()),
            "grad_diff_worst": max(diff.values()),
            "change_leaf_gap": max(change.values()),
            "worst": {"grad_leaf_gap": max(grad, key=grad.get),
                      "grad_diff": max(diff, key=diff.get),
                      "change_leaf_gap": max(change, key=change.get)},
            "left_out": sorted(set(g_ref) - set(counted))}


def routed_numbers(got: dict, routed: dict | None) -> dict:
    """Step 1 of the run judged against the reference's step 1 routed as
    it routed: the loss's relative gap; the gap between the norms of the
    clipped gradient by the worst leaf and the norm of their difference
    by the median leaf, each over the larger of the reference leaf's norm
    and the median leaf's.  And the routing itself, which the comparison
    at one routing takes from the run judged: the share of its routed
    slots whose expert lies outside the reference's own top k, and the
    mean and widest logit gap by which such an expert lies below the
    reference's k-th best.  Every number is infinite where ``routed`` is
    ``None`` (the run did not route the step's batch)."""
    if routed is None:
        return dict.fromkeys(("routed_loss_gap", "routed_grad_leaf_gap",
                              "routed_grad_diff_median", "route_outside",
                              "route_gap_mean", "route_gap_widest"),
                             float("inf"))
    g_ref = routed["grad_norms"]
    grad = _leaf_gaps(got["grad_norms"], g_ref)
    diff = _leaf_diffs(got["grads1"], routed["grads1"], g_ref)
    out = routed["outside"]
    return {"routed_loss_gap": abs(got["losses"][0] - routed["loss"])
            / abs(routed["loss"]),
            "routed_grad_leaf_gap": max(grad.values()),
            "routed_grad_diff_median": statistics.median(diff.values()),
            "route_outside": float((out > 0).float().mean()),
            "route_gap_mean": float(out.mean()),
            "route_gap_widest": float(out.max()),
            "worst_routed": max(grad, key=grad.get)}


def _leaf_gaps(got: dict, ref: dict) -> dict:
    """Each leaf's gap between two norms, over the larger of the
    reference's and the median reference leaf's."""
    med = statistics.median(ref.values())
    return {k: abs(got[k] - v) / max(v, med) for k, v in ref.items()}


def _leaf_diffs(got: dict, ref: dict, ref_norms: dict) -> dict:
    """Each leaf's norm of the difference, over the larger of the
    reference's norm and the median reference leaf's."""
    med = statistics.median(ref_norms.values())
    out = {}
    for k, g in ref.items():
        mine = got[k].to(g.device).float()
        out[k] = float((mine - g).norm()) / max(ref_norms[k], med)
        del mine
    return out


def _finite(x: float) -> float:
    return x if math.isfinite(x) else float("inf")
