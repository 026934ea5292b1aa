"""The JAX package's six examples on the port: each runs as
``python -m repro_torch.examples.<name>``, takes ``--device`` (default: the
GPU, :func:`repro_torch.device.resolve_device`; ``cpu`` runs the kernels'
plain versions on the host), asserts what its reference asserts and
prints ``OK``.  Each module's ``main(argv)`` is the entry point.

- :mod:`.quickstart` — a simulated cluster, BigRoots vs PCC;
- :mod:`.anomaly_study` — each AG kind, BigRoots vs PCC, the edge ablation;
- :mod:`.fault_tolerance_demo` — closed-loop A/B, supervised restart,
  elastic re-mesh;
- :mod:`.serve_demo` — batched serving with live diagnosis;
- :mod:`.train_100m_bigroots` — training with live diagnosis and an
  injected anomaly;
- :mod:`.fleet_demo` — host processes shipping telemetry over the
  transport, causes byte-identical to in-process replay.
"""
