"""Serving cells: a closed loop of clients into the port's batched engine.

Each round every client sends one request and waits for its answer; the
engine serves the round as one batch (prefill, then greedy decode steps).
A request is timed from its send to the moment the device has finished
its prefill, whose last position's logits give its first token (the
harness waits on the device at the end of each prefill call); the round's
prompt length goes round the workload's cycle.  After the window, a sample of the
finished requests drawn from the seed, the longest among them, is run
through the configuration's plain reference once over prompt and served
tokens.
"""
from __future__ import annotations

import math
import time

import numpy as np
import torch

from ..traffic import requests as req_traffic
from ..yardstick import work
from . import common, weights
from .common import port_config
from .spans import Spans

#: The program's entries a serving cell traces where its configuration
#: lists none: the expert FFN (K5) and prefill attention (K2).
ENTRIES = [{"entry": "moe_gmm_ffn", "span": "moe_gmm"},
           {"entry": "mha_flash", "span": "flash"}]


class ServeCell:
    """One serving cell.  ``model`` overrides widths (host tests);
    ``fault="token"`` alters every token a decode step produces, where it
    produces it."""

    def __init__(self, cell: dict, seed: int, device: torch.device, *,
                 model: dict | None = None,
                 fault: str | None = None) -> None:
        self.cell = cell
        self.wl = cell["workload"]
        self.m = dict(cell["config"]["model"], **(model or {}))
        self.ref = common.reference(cell["config"])
        self.entries = cell["config"].get("entries", ENTRIES)
        self.seed = seed % (1 << 63)
        self.device = device
        self.fault = fault
        self.spans = Spans(device, events=False)
        self.batches: list[dict] = []
        self.failed = 0

    def setup(self) -> None:
        from repro_torch.models import Model
        from repro_torch.serve import ServeEngine

        wl, dev = self.wl, self.device
        self.times = {}
        t = time.perf_counter()
        self.clients = wl["clients"]
        self.new = wl["new_tokens"]
        self.lengths = wl["prompt_lengths"]
        cfg = port_config(self.m)
        dtype = torch.bfloat16 if self.m["dtype"] == "bfloat16" \
            else torch.float32
        self.params = weights.make(self.ref, self.m, self.seed, dev, dtype,
                                   keep_f32=True)
        self.engine = ServeEngine(
            Model(cfg), self.params, max_len=max(self.lengths) + self.new
            + 8, batch_size=self.clients, device=dev)
        eng = self.engine
        self._cur: dict = {}
        # The first token of each batch as the engine feeds it to its
        # first decode step, and the moment its prefill is done.
        self.spans.wrap(eng, "_prefill", "prefill_call", sync=True,
                        record=self._on_prefill)
        self.spans.wrap(eng, "_decode_once", "decode_call",
                        record=self._on_decode)
        if self.fault == "token":
            inner = eng._decode_once

            def altered(nxt, cache):
                out, cache = inner(nxt, cache)
                return (out + 1) % self.m["vocab"], cache
            eng._decode_once = altered
        self.times["build"] = time.perf_counter() - t
        # Warm-up: one round of every prompt length the cycle holds.
        for i, length in enumerate(sorted(set(self.lengths))):
            t = time.perf_counter()
            ok = self.round(i, length, warm=True)["ok"]
            self.times[f"warm{length}"] = time.perf_counter() - t
            if not ok:
                raise RuntimeError(f"the warm-up round of {length} failed: "
                                   f"{self.batches[-1]['error']}")
        self.batches.clear()
        self.failed = 0

    def _on_prefill(self, args, kwargs, out) -> None:
        self._cur["first_token_t"] = time.perf_counter()
        self._cur["logits"] = out[0]

    def _on_decode(self, args, kwargs, out) -> None:
        self._cur["steps"] = self._cur.get("steps", 0) + 1
        if self._cur["steps"] == 1:
            self._cur["t1"] = args[0]

    def round(self, index: int, length: int, warm: bool = False) -> dict:
        """One round: every client sends its request, the engine serves
        the batch; returns the round's record."""
        from repro_torch.serve import Request

        toks = req_traffic.prompts(self.seed, index, self.clients, length,
                                   self.m["vocab"], warm)
        self._cur = {}
        sent = time.perf_counter()
        reqs = [Request(f"{index}/{c}", toks[c], max_new_tokens=self.new)
                for c in range(self.clients)]
        error = None
        try:
            with self.spans.span("batch"):
                self.engine.run(reqs)
        except Exception as e:  # a failed request is counted, not fatal
            error = repr(e)[:500]
        done = time.perf_counter()
        cur = self._cur
        if error is None and "first_token_t" not in cur:
            error = "the engine served the round without a prefill call"
        ok = error is None
        rec = {"index": index, "length": length, "sent": sent, "done": done,
               "first": cur.get("first_token_t"), "ok": ok,
               "error": error,
               "prompts": toks, "t1": cur.get("t1"),
               "logits_ok": (torch.isfinite(cur["logits"]).all()
                             if "logits" in cur else None),
               "outputs": [list(r.output) for r in reqs]}
        self.batches.append(rec)
        return rec

    def trace_entries(self) -> None:
        self.spans.events = self.device.type == "cuda"
        common.trace_entries(self.spans, self.entries)

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        i = 0
        while time.perf_counter() - t0 < seconds:
            length = req_traffic.prompt_length(self.seed, self.lengths, i)
            self.round(i, length)
            i += 1
        if self.device.type == "cuda":
            torch.cuda.synchronize()
        t1 = time.perf_counter()
        for b in self.batches:
            if not b["ok"] or (b["logits_ok"] is not None
                               and not bool(b["logits_ok"])):
                b["ok"] = False
        self.failed = sum(self.clients for b in self.batches if not b["ok"])
        return {"t0": t0, "t1": t1,
                "attempted": self.clients * len(self.batches),
                "failed": self.failed}

    def close(self) -> None:
        self.spans.restore()

    def free(self) -> None:
        self.engine = None
        if self.device.type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()

    # -- metrics ------------------------------------------------------------------
    def served_tokens(self) -> int:
        return sum(self.clients * (b["length"] + self.new)
                   for b in self.batches if b["ok"])

    def end_to_end(self, w: dict) -> dict:
        out = {"serve_tokens_per_s": self.served_tokens()
               / (w["t1"] - w["t0"])}
        ttft = [(b["first"] - b["sent"]) * 1e3 for b in self.batches
                for _ in range(self.clients) if b["ok"]]
        if ttft:
            out["ttft_p95_ms"] = float(np.percentile(ttft, 95))
        return out

    def layer_context(self, w: dict) -> dict:
        ok = [b for b in self.batches if b["ok"]]
        prefill = [(b["first"] - b["sent"]) * 1e3 for b in ok]
        decode = [(b["done"] - b["first"]) * 1e3 for b in ok]
        return {"tokens": self.served_tokens(),
                "prefill_ms": prefill, "decode_ms": decode,
                **common.entry_context(self.spans, self.entries),
                "active_params": work.active_params(self.ref, self.m),
                "model": self.m}

    # -- correctness ------------------------------------------------------------
    def sample(self) -> list[tuple[dict, int]]:
        """(batch, client) pairs drawn from the seed, the longest prompt's
        request among them."""
        done = [b for b in self.batches if b["ok"]]
        pairs = [(bi, c) for bi in range(len(done))
                 for c in range(self.clients)]
        k = min(self.wl["check"]["sample_requests"], len(pairs))
        rng = np.random.default_rng([self.seed, 19])
        pick = [pairs[i] for i in rng.choice(len(pairs), size=k,
                                             replace=False)]
        top = max(b["length"] for b in done)
        if all(done[bi]["length"] < top for bi, _ in pick):
            longest = [i for i, b in enumerate(done) if b["length"] == top]
            pick[-1] = (longest[int(rng.integers(len(longest)))],
                        int(rng.integers(self.clients)))
        return [(done[bi], c) for bi, c in pick]

    def served(self, b: dict, c: int) -> list[int]:
        return [int(b["t1"][c, 0])] + [int(t) for t in b["outputs"][c]]

    def gaps(self, control=None) -> dict:
        """The widest gap by which a served token's logit lies below the
        reference's best at its position, over the sample; with
        ``control``, the gap of the token the control's product puts
        first at each position instead.  Beside it the gaps' mean and the
        share of positions whose token is not the reference's best."""
        all_gaps = []
        by_len: dict[int, list] = {}
        for b, c in self.sample():
            by_len.setdefault(b["length"], []).append((b, c))
        step = self.wl["check"]["ref_batch"]
        for length, group in sorted(by_len.items()):
            for j in range(0, len(group), step):
                part = group[j:j + step]
                served = [self.served(b, c) for b, c in part]
                seq = np.stack([np.concatenate(
                    [b["prompts"][c], np.asarray(s[:-1], np.int32)])
                    for (b, c), s in zip(part, served)])
                toks = torch.from_numpy(seq).to(self.device)
                ref = self.ref.logits_at(self.params, self.m, toks,
                                         length - 1)
                if control is not None:
                    lo = self.ref.logits_at(self.params, self.m, toks,
                                            length - 1, mm=control)
                    chosen = lo.argmax(-1)
                    del lo
                else:
                    chosen = torch.tensor(served, device=self.device)
                gap = ref.max(-1).values - ref.gather(
                    -1, chosen[..., None])[..., 0]
                all_gaps.append(gap.flatten().float().cpu())
                del ref
        g = torch.cat(all_gaps)
        return {"gap": float(g.max()), "tokens": int(g.numel()),
                "gap_mean": float(g.mean()),
                "not_best": float((g > 0).float().mean())}

    def check(self) -> list[dict]:
        """The mean gap over the sample's served tokens, beside its limit,
        and how many tokens were compared (the widest gap and the share of
        tokens that are not the reference's best go to ``info``)."""
        lim = self.wl["limits"]
        if not any(b["ok"] for b in self.batches):
            return [{"name": "token_gap_mean", "value": float("inf"),
                     "limit": lim["token_gap_mean"]}]
        t0 = time.perf_counter()
        g = self.gaps()
        self.info = {"token_gap_widest": g["gap"],
                     "tokens_not_best": g["not_best"],
                     "reference_s": time.perf_counter() - t0,
                     "rounds_ms": [round((b["done"] - b["sent"]) * 1e3)
                                   for b in self.batches]}
        mean = g["gap_mean"] if math.isfinite(g["gap_mean"]) else float("inf")
        return [{"name": "token_gap_mean", "value": mean,
                 "limit": lim["token_gap_mean"]},
                {"name": "tokens_compared", "value": g["tokens"],
                 "limit": lim["tokens_compared"], "at_least": True}]
