"""``Trainer.fit`` under the EMA placements ``host_cadence`` and ``hostcompute`` in the
port against the JAX trainer on the same dataset, from the same initial parameters
and with JAX's draws (tests/test_torch_trainer.py's ``_fit_parity``), on the CPU at
Micro size. The host-EMA classes and the checkpoints are tests/test_torch_host_ema.py."""

import numpy as np
import pytest
import torch

from test_torch_trainer import (_assert_fit_parity, _fit_parity, _one_torch_thread,  # noqa: F401
                                dataset_dir, make_config)


@pytest.mark.parametrize("placement,start,interval", [("host_cadence", "2ba", "2ba"),
                                                      ("hostcompute", "1ba", "1ba")])
def test_fit_placements_match_jax_trainer(dataset_dir, monkeypatch, placement, start,
                                          interval):
    """Trainer.fit for 3 steps (Micro, fp32, K = 2, tests/test_torch_trainer.py's
    recipe) with the EMA at ``placement`` in both frameworks: host_cadence at
    ema_start 2 and update_interval 2 mirrors the parameters at step 0, skips step 1
    and decays at step 2; hostcompute at ema_start 1 and interval 1 makes its chunks
    at step 1 (JAX's mirror) and decays at step 2. The losses,
    grad norms and parameters as test_fit_matches_jax_trainer holds them (2 x the
    sum of the lrs); the EMA from eval_params within the same bound plus two bf16
    ulps of the entry where the placement rounds the parameters to bf16 (a
    parameter that parts by the bound may round the other way)."""
    cfg = make_config(dataset_dir)
    cfg["algorithms"]["ema"] = {"_target_": "diffusion.algorithms.ema.EMA", "smoothing": 0.9,
                                "ema_start": start, "update_interval": interval,
                                "placement": placement}
    ptrainer, trows, jrows, jfinal, jema = _fit_parity(cfg, monkeypatch, 0.75)
    tol = _assert_fit_parity(ptrainer, trows, jrows, jfinal, 3)
    assert ptrainer.ema_placement == placement
    assert (ptrainer.state.ema_params is None) == (placement == "hostcompute")
    ema = ptrainer._ema_weights()
    ulp = 2 ** -7 if placement == "hostcompute" else 0.0
    lagging = 0
    for name, e in ema.items():
        j = jema[name]
        assert np.all(np.abs(e.numpy() - j) <= tol + ulp * np.abs(j)), name
        lagging += not torch.equal(e, ptrainer.state.params[name])
    assert lagging >= 0.9 * len(ema)
