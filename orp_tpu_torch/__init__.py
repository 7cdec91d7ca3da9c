"""orp_tpu_torch: the PyTorch / CUDA (H100) port of the orp_tpu deep-hedging framework.

A package of its own beside the JAX reference ``orp_tpu``: it imports
``torch`` and never ``jax``, and nothing of ``orp_tpu``. Its layout mirrors
the reference (``qmc/``, ``sde/``, ``models/``, ``train/``, ``parallel/``,
``risk/``, ``api/``, ``serve/``, ``guard/``, ``obs/``, ``utils/``). Hand-written CUDA kernels for
``sm_90a`` live in ``csrc/`` and are built with ``nvcc`` on first use.

Entry points run on the card (``device=None`` means ``cuda``) unless the
caller passes ``device="cpu"``:

- ``orp_tpu_torch.api.european_hedge(euro, sim, train, device=...)`` and
  ``orp_tpu_torch.api.heston_hedge(heston, sim, train, device=...)``: the
  backward walk, by Adam (``train.optimizer="adam"``, the default) or
  Gauss-Newton (``"gauss_newton"``); ``fused=True`` with no host read
  between dates, or the host loop with ``checkpoint_dir`` (resume) and
  ``nan_guard`` (the trainer ladder)
- ``orp_tpu_torch.api.pension_hedge(cfg, device=...)``: the pension liability
  with the dual walk (``dual_mode="shared"`` or ``"separate"``, the quantile
  leg by Adam or by IRLS Gauss-Newton)
- ``orp_tpu_torch.api.european_oos(policy, ...)``, ``heston_oos(policy, ...)``
  and ``pension_oos(policy, cfg, ...)``
- ``orp_tpu_torch.serve.load_bundle(dir)``
- ``orp_tpu_torch.serve.HedgeEngine(policy, device=...)``
- the option analytics: ``orp_tpu_torch.risk.asian_call_qmc``,
  ``down_and_out_call_qmc``, ``lookback_call_qmc``, ``price_surface``, ...
  and ``orp_tpu_torch.train.bermudan_lsm`` (each with ``device=...``)
- ``with orp_tpu_torch.obs.telemetry(dir): ...``: a telemetry bundle of any
  of the above (the JAX package's ``events.jsonl``, ``metrics.prom``,
  ``manifest.json``, ``flight.jsonl``)
"""

import pathlib

#: the committed north-star policy bundle (trained by the JAX package)
NORTH_STAR_POLICY = pathlib.Path(__file__).parent / "_data" / "north_star_policy"
#: a 4,096-path JAX Heston walk: its initial params, per-date params and report
HESTON_WALK = pathlib.Path(__file__).parent / "_data" / "heston_walk"
#: a 4,096-path JAX pension dual walk: initial params, per-date params, report, replay
PENSION_WALK = pathlib.Path(__file__).parent / "_data" / "pension_walk"
