"""Data parallelism over ranks, the full-tree step: four ``gloo`` ranks, one
clip each, take one ``train_step`` (every leaf fp32, gradients of every
leaf, the frozen ones dropped by the optimizer) and are held to the port's
one-process step over the four clips and to the JAX ``train_step`` jitted
on a ``data=4`` mesh, with the metrics, ranks and frozen leaves held as in
``tests/test_torch_data_parallel.py``.

The leaves: the ranks against one process, and one process against JAX,
each within ``UPDATE_TOL · lr`` (one step); the ranks against JAX within
the sum of those two legs. One Adam step at ``eps = 1e-5`` turns a gradient
difference Δg of a near-zero gradient into ``Δg / eps`` of ``lr``, and the
two legs sum in different orders: measured 5.0e-7 and 5.4e-7, and 1.04e-6
for the ranks against JAX, in the same leaf
(``up_blocks_1/motion_modules_1/.../attention_blocks_1/to_out/kernel``).
"""

from tests.test_torch_data_parallel import (
    FULL_TREE,
    as_state,
    check_metrics,
    check_ranks_equal,
    jax_on_mesh,
    one_process,
    run_ranks,
)
from tests.test_torch_tokenizer import one_torch_thread  # noqa: F401
from tests.test_torch_training_step import UPDATE_TOL, check, models


def test_full_tree_ranks_equal_one_process_and_jax(tmp_path):
    cfg = FULL_TREE
    results = run_ranks(str(tmp_path), 0, 1)
    check_ranks_equal(results, ["full_params"])
    ranks = results[0]
    for r in results:
        assert r["full_metrics"] == ranks["full_metrics"]
    tm, tstate = one_process(cfg, 1, partitioned=False)
    jm, jstate = jax_on_mesh(cfg, 1, partitioned=False)
    unet = models()[4]
    bound = UPDATE_TOL * cfg.learning_rate
    check_metrics(ranks["full_metrics"], tm, "ranks vs one process")
    check_metrics(ranks["full_metrics"], jm, "ranks vs JAX")
    worst = max(float((ranks["full_params"][n] - t).abs().max())
                for n, t in tstate.params.items())
    assert worst <= bound, worst
    one_vs_jax = check(jm, jstate, tm, tstate, unet, cfg, 1)
    # the legs' sum: check(steps=2) bounds by 2 · UPDATE_TOL · lr
    ranks_vs_jax = check(jm, jstate, ranks["full_metrics"],
                         as_state(ranks["full_params"], tstate.tx.lrs),
                         unet, cfg, 2)
    print(f"full tree, worst leaf: ranks vs one process {worst:.3g}, one "
          f"process vs JAX {one_vs_jax:.3g}, ranks vs JAX "
          f"{ranks_vs_jax:.3g} (one step's bound {bound:.3g})")
