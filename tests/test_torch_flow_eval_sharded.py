"""``flow.train.evaluate_sharded`` against ``evaluate`` and the JAX
``evaluate_sharded``.

RAFT at published widths (``tests/test_torch_raft.jax_model``: flax's init
with seeded BN statistics, carried to the port by ``raft_state_from_jax``),
five samples of 64x96 with random flows and valid masks, EPE and Fl, 4
iterations:

- the port's ``evaluate_sharded`` in this process (no group) and over four
  ``gloo`` ranks (``tests/_torch_ranks.flow_eval``; samples 0-4 dealt as
  {0, 4}, {1}, {2}, {3}) equals the port's one-process ``evaluate`` within
  1e-6 relative (the same flows, summed in another order);
- it equals the JAX ``evaluate_sharded`` on a 1-device and a 4-device mesh
  (there 5 samples pad to 8 and the pad rows are masked out) within 1e-4 px
  in EPE (two fp32 RAFTs, ``tests/test_torch_raft.FLOW_ATOL``), with equal
  outlier counts;
- a metric other than EPE and Fl raises ``KeyError`` in both packages.

``train_model(eval_group=...)`` over ranks against JAX's
``train_model(eval_mesh=...)`` is in ``tests/test_torch_flow_eval_train.py``.
"""

import functools
import os
import types

import jax
import numpy as np
import pytest
import torch

from followyourclick_tpu.flow import train as jtrain
from followyourclick_tpu.parallel.mesh import create_mesh
from followyourclick_tpu_torch.flow import train as ttrain
from followyourclick_tpu_torch.flow.convert import raft_state_from_jax
from followyourclick_tpu_torch.flow.raft import RAFT, RAFTConfig
from followyourclick_tpu_torch.parallel import data_parallel as dp
from tests import _torch_ranks
from tests.test_torch_raft import FLOW_ATOL, H, W, jax_model

N_SAMPLES = 5
ITERS = 4
WORLD = 4
METRICS = ("EPE", "Fl")


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def samples(n=N_SAMPLES, seed=7):
    rs = np.random.RandomState(seed)
    return [types.SimpleNamespace(
        img1=(rs.rand(H, W, 3) * 255).astype(np.float32),
        img2=(rs.rand(H, W, 3) * 255).astype(np.float32),
        flow_gt=(3 * rs.randn(H, W, 2)).astype(np.float32),
        valid=(rs.rand(H, W) > 0.2).astype(np.float32)) for _ in range(n)]


def port_model():
    _, variables = jax_model(False)
    model = RAFT(RAFTConfig())
    model.load_state_dict(raft_state_from_jax(variables, model))
    return model


def jax_mesh(n):
    return create_mesh(data=n, model=1, devices=jax.devices()[:n])


def counts(result, n_valid):
    """(EPE sum, outlier count) from the metrics of ``n_valid`` pixels."""
    return result["EPE"] * n_valid, round(result["Fl"] * n_valid / 100.0)


def rank_job(tmp_path, **kw):
    path = os.path.join(tmp_path, "job.pt")
    torch.save(dict(state=port_model().state_dict(), samples=samples(),
                    iters=ITERS, **kw), path)
    return path


@functools.lru_cache(maxsize=None)
def references():
    """The port's ``evaluate`` and the JAX ``evaluate_sharded`` on 1- and
    4-device meshes."""
    data = samples()
    one = ttrain.evaluate(port_model(), data, iters=ITERS,
                          metrics=list(METRICS))
    jmodel, variables = jax_model(False)
    jax_results = {n: jtrain.evaluate_sharded(jmodel, variables, data,
                                              mesh=jax_mesh(n), iters=ITERS,
                                              metrics=METRICS)
                   for n in (1, WORLD)}
    return one, jax_results


def check_against_references(got, what):
    one, jax_results = references()
    n_valid = sum(float((s.valid >= 0.5).sum()) for s in samples())
    for k in METRICS:
        assert abs(got[k] - one[k]) <= 1e-6 * abs(one[k]), (what, k, got,
                                                              one)
    for n, want in jax_results.items():
        assert abs(got["EPE"] - want["EPE"]) <= FLOW_ATOL, (what, n, got,
                                                            want)
        assert counts(got, n_valid)[1] == counts(want, n_valid)[1], (
            what, n, got, want)
    assert 0 < got["Fl"] < 100
    return one, jax_results


def test_one_process_equals_evaluate_and_jax():
    model = port_model().train()
    got = ttrain.evaluate_sharded(model, samples(), iters=ITERS,
                                  metrics=METRICS)
    assert all(m.training for m in model.modules())
    one, jax_results = check_against_references(got, "one process")
    print(f"EPE: sharded {got['EPE']!r}, evaluate {one['EPE']!r}, JAX "
          f"1 / 4 devices {jax_results[1]['EPE']!r} / "
          f"{jax_results[WORLD]['EPE']!r}; Fl {got['Fl']!r}")


def test_four_ranks_equal_evaluate_and_jax(tmp_path):
    results = dp.launch(_torch_ranks.flow_eval, WORLD,
                        (rank_job(str(tmp_path)),), timeout=240.0)
    assert not any(r["jax_loaded"] for r in results)
    for r in results:
        assert r["eval"] == results[0]["eval"]
    check_against_references(results[0]["eval"], "four ranks")


@pytest.mark.parametrize("metrics", [("EPE", "AAE"), "foo", ("Fl", "EPE",
                                                             "bar")])
def test_unknown_metrics_raise(metrics):
    with pytest.raises(KeyError):
        ttrain.evaluate_sharded(None, [], metrics=metrics)
    with pytest.raises(KeyError):
        jtrain.evaluate_sharded(None, None, [], mesh=jax_mesh(1),
                                metrics=metrics)
