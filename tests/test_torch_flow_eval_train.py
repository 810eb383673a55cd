"""``flow.train.train_model(eval_every=1, eval_group=...)`` over two
``gloo`` ranks against the JAX ``train_model(eval_every=1,
eval_mesh=<2-device mesh>)``: RAFT at published widths
(``tests/test_torch_raft.jax_model``), one step on the same batch of 2
pairs of 64x96 on every rank (as the JAX trainer takes it on every host;
the published schedule at ``eps = 1e-5``, 12 iterations), then the
evaluation of five samples dealt over the ranks (3 and 2; JAX pads its
host's 5 to 6), 32 iterations. Four ranks are ``evaluate_sharded``'s own
test (``tests/test_torch_flow_eval_sharded.py``); two keep the four RAFT
training steps of four ranks off the suite's cores. The step's
loss and EPE within 1e-5 relative, ``val/EPE`` within 1e-4 px
(``tests/test_torch_flow_train.VAL_EPE_ATOL``), equal on every rank.
"""

import dataclasses

import jax
import numpy as np

from followyourclick_tpu.flow import train as jtrain
from followyourclick_tpu_torch.flow import train as ttrain
from followyourclick_tpu_torch.parallel import data_parallel as dp
from tests import _torch_ranks
from tests.test_torch_flow_eval_sharded import (
    _threads,  # noqa: F401
    jax_mesh,
    rank_job,
    samples,
)
from tests.test_torch_flow_train import VAL_EPE_ATOL, _batch
from tests.test_torch_raft import jax_model

WORLD = 2


def test_train_model_over_ranks_evaluates_as_jax(tmp_path):
    jmodel, variables = jax_model(False)
    cfg = jtrain.FlowTrainConfig(eps=1e-5, iters=12)
    batch = _batch(0)
    jlogs = {}
    jtrain.train_model(
        jmodel, {"params": jax.tree_util.tree_map(np.copy,
                                                  variables["params"]),
                 "batch_stats": variables["batch_stats"]}, iter([batch]),
        cfg, work_dir=str(tmp_path / "jax"), max_steps=1, resume=False,
        log_fn=lambda step, m: jlogs.update(m), eval_dataset=samples(),
        eval_every=1, eval_mesh=jax_mesh(WORLD))
    path = rank_job(str(tmp_path), train=True, batch=batch,
                    root=str(tmp_path / "port"),
                    cfg=ttrain.FlowTrainConfig(**dataclasses.asdict(cfg)))
    results = dp.launch(_torch_ranks.flow_eval, WORLD, (path,),
                        timeout=240.0)
    assert not any(r["jax_loaded"] for r in results)
    logs = results[0]["logs"]
    for r in results:
        assert r["logs"]["val/EPE"] == logs["val/EPE"]
    for k in ("loss", "epe"):
        np.testing.assert_allclose(logs[k], jlogs[k], rtol=1e-5, err_msg=k)
    print(f"val/EPE over {WORLD} ranks {logs['val/EPE']!r} against JAX's "
          f"on a {WORLD}-device mesh {jlogs['val/EPE']!r}")
    np.testing.assert_allclose(logs["val/EPE"], jlogs["val/EPE"], rtol=0,
                               atol=VAL_EPE_ATOL)
