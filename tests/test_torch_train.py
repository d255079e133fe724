"""The port's trainer (``repro_torch.launch.train``) on the CPU: the
pipeline loss's sequential branch, bit-identical kill-and-resume, and
checkpoints crossing the packages with the optimizer's NamedTuple state.

* ``make_pipeline_loss(mesh=None)`` equals the port's ``lm_loss`` on the
  same parameters (the same operations, layer by layer: 1e-6 relative);
* ``train(lm_tiny)`` 6 steps straight equals 3 steps, a crash and a
  resume to 6, bit for bit, with and without int8 compression, as
  ``tests/test_fault_tolerance.py::test_kill_restart_resume_bit_identical``
  holds JAX's;
* a JAX ``train`` checkpoint at step 3 restores into the port's
  ``(params, AdamWState, residuals)`` tree leaf for leaf with
  ``AdamWState.step == 3`` (the NamedTuple's leaves are named ``.step``,
  ``.m/...``, as JAX names them), and a port checkpoint restores into
  JAX's tree the same way.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.launch import train as jtrain
from repro.train.checkpoint import Checkpointer as JCheckpointer
from repro_torch.launch import train as ttrain
from repro_torch.models.transformer import init_lm_params, lm_loss
from repro_torch.optim.adamw import AdamWState, init_adamw
from repro_torch.optim.compression import init_residuals
from repro_torch.train.checkpoint import Checkpointer, _flatten_with_names

CPU = torch.device("cpu")
CFG = ttrain.PRESETS["lm_tiny"]


def batch(cfg, b, t, seed=0):
    rng = np.random.default_rng(seed)
    return {k: torch.from_numpy(rng.integers(0, cfg.vocab, (b, t),
                                             dtype=np.int32))
            for k in ("tokens", "targets")}


@pytest.mark.parametrize("stages,micro", [(2, None), (4, 2), (2, 4)])
def test_pipeline_loss_sequential_branch_equals_lm_loss(stages, micro):
    cfg = ttrain.PRESETS["lm_pipe"]
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    b = batch(cfg, 4, 16)
    want = lm_loss(cfg, params, b)
    got = ttrain.make_pipeline_loss(cfg, stages, None, micro)(params, b)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0)


def test_pipeline_loss_refuses_moe_and_ragged_batches():
    import dataclasses
    with pytest.raises(ValueError, match="dense"):
        ttrain.make_pipeline_loss(
            dataclasses.replace(CFG, n_experts=4), 2)
    cfg = ttrain.PRESETS["lm_pipe"]
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    with pytest.raises(ValueError, match="microbatches"):
        ttrain.make_pipeline_loss(cfg, 2, None, 3)(params, batch(cfg, 4, 8))


@pytest.mark.parametrize("compress", [False, True])
def test_kill_restart_resume_bit_identical(tmp_path, compress):
    kw = dict(batch=2, seq=32, compress=compress, device="cpu")
    p_straight, l_straight = ttrain.train(
        CFG, steps=6, ckpt_dir=str(tmp_path / "a"), ckpt_every=100, **kw)
    _, l_first = ttrain.train(CFG, steps=3, ckpt_dir=str(tmp_path / "b"),
                              ckpt_every=3, **kw)
    # "crash" here; a new run resumes from step 3
    p_resumed, l_rest = ttrain.train(CFG, steps=6,
                                     ckpt_dir=str(tmp_path / "b"),
                                     ckpt_every=3, **kw)
    assert l_first + l_rest == l_straight
    for (na, a), (nb, b) in zip(_flatten_with_names(p_straight),
                                _flatten_with_names(p_resumed)):
        assert na == nb and torch.equal(a, b), na


def test_train_step_with_pipeline_stages_runs():
    _, losses = ttrain.train(ttrain.PRESETS["lm_pipe"], steps=2, batch=4,
                             seq=16, ckpt_dir=None, pipeline_stages=2,
                             device="cpu")
    assert len(losses) == 2 and all(np.isfinite(losses))


def port_tree(cfg, compress):
    params = init_lm_params(cfg, torch.Generator().manual_seed(0))
    res = init_residuals(params) if compress else \
        jax.tree.map(lambda _: torch.zeros(()), params)
    return params, init_adamw(params), res


@pytest.mark.parametrize("compress", [False, True])
def test_jax_checkpoint_restores_into_the_port(tmp_path, compress):
    d = str(tmp_path / "jax")
    jcfg = jtrain.PRESETS["lm_tiny"]
    p_jax, _ = jtrain.train(jcfg, steps=3, batch=2, seq=32, ckpt_dir=d,
                            ckpt_every=3, compress=compress)
    like = port_tree(CFG, compress)
    (params, opt, res), _, step = Checkpointer(d).restore(like)
    assert step == 3 and isinstance(opt, AdamWState)
    assert int(opt.step) == 3
    for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(p_jax)):
        np.testing.assert_array_equal(a, np.asarray(b))
    names = [n for n, _ in _flatten_with_names(like)]
    assert "1/.step" in names and "1/.m/embed" in names
    # the restored tree continues on the port
    ckpt = Checkpointer(d)
    _, losses = ttrain.train(CFG, steps=4, batch=2, seq=32, ckpt_dir=d,
                             ckpt_every=100, compress=compress,
                             device="cpu")
    assert len(losses) == 1 and np.isfinite(losses[0])
    assert ckpt.latest_step() == 4


def test_port_checkpoint_restores_into_jax(tmp_path):
    d = str(tmp_path / "port")
    ttrain.train(CFG, steps=2, batch=2, seq=32, ckpt_dir=d, ckpt_every=2,
                 device="cpu")
    jcfg = jtrain.PRESETS["lm_tiny"]
    jp = jax.eval_shape(lambda: jtrain.init_lm_params(
        jcfg, jax.random.PRNGKey(0)))
    jp = jax.tree.map(lambda s: jnp.zeros(s.shape, s.dtype), jp)
    like = (jp, jtrain.init_adamw(jp),
            jax.tree.map(lambda x: jnp.zeros((), jnp.float32), jp))
    (params, opt, _), _, step = JCheckpointer(d).restore(like)
    assert step == 2 and int(opt.step) == 2
    (tp, topt, _), _, _ = Checkpointer(d).restore(port_tree(CFG, False))
    for a, b in zip(jax.tree.leaves(tp), jax.tree.leaves(params)):
        np.testing.assert_array_equal(a, np.asarray(b))
