"""Carry parameters and state from their numpy forms onto a device.

The numpy forms are the canonical storage layout shared with the JAX
package (``forecast_init``'s parameter dict, the forecaster's carried
state arrays, the packed gate batch), so the same arrays can be handed
to both packages and must produce the same results.
"""
from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .models.forecast_ssd import ForecastCell

_GATE_FIELDS = ("v", "peer_vsum", "inter_cnt", "intra_cnt", "rowmask",
                "vsum", "q", "numok", "floor")


def _tensor(a, device: torch.device, dtype=torch.float64) -> torch.Tensor:
    return torch.from_numpy(
        np.ascontiguousarray(np.asarray(a))
    ).to(device=device, dtype=dtype)


def forecast_params_from_numpy(params, device=None) -> ForecastCell:
    """The twelve arrays of ``forecast_init`` (float64; ``bo`` is 0-d) as
    a :class:`~repro_torch.models.forecast_ssd.ForecastCell` on
    ``device``."""
    return ForecastCell(params, resolve_device(device))


def forecaster_state_from_numpy(index, h, seen, last_tick, anchors,
                                device=None) -> dict:
    """A forecaster's carried recurrence state as the port keeps it: the
    ``[S, H, N]`` state on ``device``, the bookkeeping on the host.

    Returns a dict with keys ``index`` (``{(stage_id, node): row}``),
    ``h`` (float64 tensor), ``seen`` / ``last_tick`` (int64 numpy) and
    ``anchors`` (list of newest task ids);
    :meth:`repro_torch.core.forecast.Forecaster.load_state` installs it."""
    h_t = _tensor(h, resolve_device(device))
    rows = h_t.shape[0]
    seen = np.array(seen, dtype=np.int64)
    last_tick = np.array(last_tick, dtype=np.int64)
    anchors = list(anchors)
    index = {(str(s), str(n)): int(i) for (s, n), i in dict(index).items()}
    if not (len(seen) == len(last_tick) == len(anchors) == rows
            == len(index)):
        raise ValueError("forecaster state arrays disagree on the row count")
    return {"index": index, "h": h_t, "seen": seen,
            "last_tick": last_tick, "anchors": anchors}


def gate_batch_from_numpy(batch_like, device=None) -> tuple:
    """The nine gate inputs of any object with the fields of
    :class:`~repro_torch.core.fleet.FleetGateBatch` (the JAX package's
    packed batch included) as float64 tensors on ``device``, in the
    argument order of
    :func:`repro_torch.kernels.bigroots_gates.gates_launch`."""
    dev = resolve_device(device)
    return tuple(_tensor(getattr(batch_like, f), dev) for f in _GATE_FIELDS)
