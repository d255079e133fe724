"""LM serving over a mesh: the port's parameters, KV cache and batch laid
out by ``lm_param_shardings``, ``lm_cache_shardings`` and
``lm_batch_shardings`` (FSDP over dp x TP over ``model``), each rank
computing on its blocks, against the JAX package's unsharded model, on
the CPU.

Configs are the llama3.2-1b and phi3.5-moe smoke configs in f32 (4 heads,
2 KV heads, d_model 64).  The meshes are (2, 2), (1, 4) and (4, 1) of
``LocalTiles``: at (1, 4) the 2 KV heads do not divide ``model``, so the
prefill splits its query rows over ``model`` and the decode cache its
time axis (the slices' softmaxes merged by their log-sum-exp), as JAX
falls back.  Parameters are drawn by JAX and cut into each rank's blocks
(``lm_params_from_numpy(mesh=, rank=)``), and the port's own per-rank
draw (``init_lm_params(mesh=, rank=)``) is held to its whole draw block
for block.

Tolerance: f32, 1e-5 x max(1, max |ref|).  As in
``tests/test_torch_transformer.py``, both packages' attention is swapped
for its f32 form (JAX's flash for the Pallas kernel in interpret mode,
both decodes for an f32 softmax; the port's slice decode for the same in
f32), so the two compute the same f32 function: the products split over
ranks add in other orders, a few f32 ulps of the largest logit.

The MoE FFN's expert parallelism on each rank's rows over processes at
``data`` 2 (``_moe_ep``, JAX's ``_ffn_moe_ep`` under ``shard_map``) runs
over four gloo processes at (2, 2) against the same layout over
``LocalTiles``, which is held to the whole model with EP on a whole batch
(``_ffn_moe_ep``, the same ``_moe_ep``, which
``tests/test_torch_moe_ep.py`` holds to JAX's) on the same mesh.
"""
import dataclasses
import pathlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import decode_attention_ref
from repro.models import transformer as jtr
from repro_torch.configs import lm_archs
from repro_torch.dist import ctx, sharding
from repro_torch.launch import serve, steps
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer
from test_torch_transformer import (carried, close, configs,  # noqa: F401
                                    f32_attention, tokens)

CPU = torch.device("cpu")
TOL = 1e-5
MESHES = [(2, 2), (1, 4), (4, 1)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def decode_lse_f32(q, k_cache, v_cache, lengths):
    """``decode_attention_lse`` with every step in f32 (``decode_f32`` on
    a slice, with its log-sum-exp)."""
    B, _, H, dh = q.shape
    G = H // k_cache.shape[2]
    kf = k_cache.float().repeat_interleave(G, dim=2)
    vf = v_cache.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,bshd->bhs", q[:, 0].float() / np.sqrt(dh), kf)
    mask = torch.arange(k_cache.shape[1])[None, :] < lengths[:, None]
    s = s.masked_fill(~mask[:, None, :], float("-inf"))
    lse = torch.logsumexp(s, -1)
    p = torch.exp(s - torch.where(torch.isfinite(lse), lse, 0.0)[..., None])
    return torch.einsum("bhs,bshd->bhd", p, vf)[:, None], lse


@pytest.fixture
def f32_everywhere(f32_attention, monkeypatch):  # noqa: F811
    monkeypatch.setattr(transformer, "decode_attention_lse", decode_lse_f32)


@pytest.fixture
def on_mesh():
    """Register a mesh for the test and clear it after."""
    def register(shape):
        return ctx.set_dist_mesh(make_host_mesh(*shape, device="cpu"))
    yield register
    ctx.set_dist_mesh(None)


def placed(tc, mesh, jp):
    """JAX's parameters cut into every rank's blocks."""
    tree = jax.tree.map(np.asarray, jp)
    return sharding.Placed(mesh, transformer.lm_param_specs(tc, mesh), [
        transformer.lm_params_from_numpy(tc, tree, CPU, mesh, r)
        for r in mesh.local_ranks])


def held_blocks(mesh, whole, P):
    """Each rank holds its block of every leaf and no more."""
    for r, blocks in zip(mesh.local_ranks, P.blocks):
        want = sharding.map_specs(
            lambda w, s: sharding.shard_block(w, mesh, s, r), whole,
            P.specs)
        for g, w in zip(sharding.tree_leaves(blocks),
                        sharding.tree_leaves(want)):
            assert g.shape == w.shape and torch.equal(g, w)


@pytest.fixture(scope="module")
def llama():
    jc, tc = configs("LLAMA32_1B", "f32")
    jp, tp = carried(jc, tc, seed=5)
    return jc, tc, jp, tp


START_LENGTHS = np.array([0, 3, 7, 12], np.int32)


def decode_start(tc, B=4, Tmax=16):
    """Caches holding earlier keys and values up to ragged lengths."""
    rng = np.random.default_rng(7)
    start = rng.standard_normal((2, tc.n_layers, B, Tmax, tc.n_kv_heads,
                                 tc.dh)).astype(np.float32)
    start[:, :, 0] = 0.0
    return start


@pytest.fixture(scope="module")
def jax_refs(llama):
    """JAX's prefill logits and three decode steps (f32 attention), once
    for every mesh."""
    jc, tc, jp, tp = llama
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jtr, "flash_attention_xla",
                   lambda q, k, v, causal=True, chunk=512: j_flash(
                       q, k, v, causal=causal, interpret=True))
        mp.setattr(jtr, "decode_attention", decode_attention_ref)
        tok = tokens(jc, 2, 16, seed=6)
        prefill = np.asarray(jtr.lm_forward(jc, jp, jnp.asarray(tok))[0])
        jcache = tuple(jnp.asarray(c).astype(jnp.bfloat16)
                       for c in decode_start(tc))
        feed = tokens(jc, 4, 3, seed=8)
        steps_ = []
        for s in range(3):
            jl, jcache = jtr.lm_decode_step(
                jc, jp, jnp.asarray(feed[:, s:s + 1]), jcache,
                jnp.asarray(START_LENGTHS + s))
            steps_.append(np.asarray(jl))
    return dict(tok=tok, prefill=prefill, feed=feed, steps=steps_,
                cache=[np.asarray(c, np.float32) for c in jcache])


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_prefill_over_a_mesh_equals_jax(llama, jax_refs, shape,
                                        f32_everywhere, on_mesh):
    jc, tc, jp, tp = llama
    mesh = on_mesh(shape)
    tok, want = jax_refs["tok"], jax_refs["prefill"]
    P = placed(tc, mesh, jp)
    held_blocks(mesh, tp, P)
    # every sharded leaf at a quarter of the whole where both axes cut it
    whole_bytes = sum(x.numel() for x in sharding.tree_leaves(tp))
    held = [sum(x.numel() for x in sharding.tree_leaves(b))
            for b in P.blocks]
    assert max(held) < whole_bytes and len(set(held)) == 1
    logits, _ = transformer.lm_forward(tc, P, torch.from_numpy(tok))
    assert logits.specs[1] == ("model" if shape[1] > 1 else None)
    close(sharding.gather_placed(logits), want, TOL)
    last = transformer.lm_last_logits(tc, P, torch.from_numpy(tok))
    close(sharding.gather_placed(last), want[:, -1], TOL)
    # the port's per-rank draw: its whole draw, block for block
    gen = torch.Generator().manual_seed(1)
    whole = transformer.init_lm_params(tc, gen)
    mine = sharding.Placed(mesh, P.specs, [transformer.init_lm_params(
        tc, torch.Generator().manual_seed(1), mesh, r)
        for r in mesh.local_ranks])
    held_blocks(mesh, whole, mine)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_decode_over_a_mesh_equals_jax(llama, jax_refs, shape,
                                       f32_everywhere, on_mesh):
    """Three decode steps over ragged lengths; at (1, 4) the cache's time
    axis is split (2 KV heads over 4)."""
    jc, tc, jp, tp = llama
    mesh = on_mesh(shape)
    cache = tuple(torch.from_numpy(c).bfloat16() for c in decode_start(tc))
    spec = sharding.lm_cache_shardings(mesh, tc, 4)
    assert spec[0][2 if tc.n_kv_heads % shape[1] else 3] == "model" \
        or shape[1] == 1
    P = placed(tc, mesh, jp)
    feed = jax_refs["feed"]
    for s, want in enumerate(jax_refs["steps"]):
        tl, cache = transformer.lm_decode_step(
            tc, P, torch.from_numpy(feed[:, s:s + 1]), cache,
            torch.from_numpy(START_LENGTHS + s))
        assert isinstance(cache, sharding.Placed)
        close(sharding.gather_placed(tl), want, TOL)
    for t, j in zip(sharding.gather_placed(cache), jax_refs["cache"]):
        # a written key or value may round to the neighbouring bf16 number
        close(t.float(), j, 2e-2)


def test_dense_moe_over_a_mesh_equals_the_whole_model(on_mesh):
    """``moe_impl="dense"`` on a laid-out tree at (2, 2): each rank runs
    ``_ffn_moe`` on the whole batch, the experts gathered whole, and keeps
    its rows (EP's fallback takes the same path)."""
    cfg = dataclasses.replace(lm_archs._smoke(lm_archs.PHI35_MOE),
                              compute_dtype=torch.float32)
    mesh = on_mesh((2, 2))
    whole = transformer.init_lm_params(cfg, torch.Generator().manual_seed(4))
    tok = torch.from_numpy(tokens(cfg, 2, 16, seed=11))
    want, waux = transformer.lm_forward(cfg, whole, tok)
    P = sharding.lay_out(whole, mesh, transformer.lm_param_specs(cfg, mesh))
    got, aux = transformer.lm_forward(cfg, P, tok)
    close(sharding.gather_placed(got), want.numpy(), TOL)
    close(aux, waux.numpy(), TOL)


GLOO_RANK = """
import sys
import numpy as np
import torch
import dataclasses
sys.path.insert(0, sys.argv[5])
from repro_torch.configs import lm_archs
from repro_torch.dist import ctx, sharding
from repro_torch.dist.transport import ProcessGroupTiles
from repro_torch.models import transformer

rank, world, init, out = sys.argv[1:5]
rank, world = int(rank), int(world)
torch.set_num_threads(1)
tr = ProcessGroupTiles.connect(init, rank, world, backend="gloo",
                               timeout_s=60)
try:
    mesh = ctx.set_dist_mesh(ctx.Mesh((2, 2), ("data", "model"), tr))
    cfg = dataclasses.replace(lm_archs._smoke(lm_archs.PHI35_MOE),
                              compute_dtype=torch.float32, moe_impl="ep")
    P = sharding.Placed(mesh, transformer.lm_param_specs(cfg, mesh), [
        transformer.init_lm_params(cfg, torch.Generator().manual_seed(2),
                                   mesh, rank)])
    tok = torch.from_numpy(np.random.default_rng(9).integers(
        0, cfg.vocab, (2, 16)).astype(np.int32))
    logits, aux = transformer.lm_forward(cfg, P, tok)
    (block,) = logits.blocks
    whole = sharding.gather_placed(logits)
    np.savez(f"{out}/rank{rank}.npz", block=block.numpy(),
             whole=whole.numpy(), aux=aux.numpy())
finally:
    ctx.set_dist_mesh(None)
    ProcessGroupTiles.close()
print("RANK_OK", rank)
"""


def test_ep_forward_over_gloo_equals_local_tiles(tmp_path, on_mesh):
    """EP on each rank's rows over four processes at data 2: each rank's
    logits block, drawn and computed there, equals that rank's over
    ``LocalTiles``; and over ``LocalTiles`` EP on each rank's rows equals
    the whole model's, whose EP runs on the whole batch
    (``_ffn_moe_ep``), on the same mesh."""
    from test_torch_dist_gloo import ranks
    cfg = dataclasses.replace(lm_archs._smoke(lm_archs.PHI35_MOE),
                              compute_dtype=torch.float32, moe_impl="ep")
    tok = torch.from_numpy(tokens(cfg, 2, 16, seed=9))
    with ranks(GLOO_RANK, 4, tmp_path, str(tmp_path),
               str(pathlib.Path(__file__).parent)):
        mesh = on_mesh((2, 2))
        whole = transformer.init_lm_params(cfg,
                                           torch.Generator().manual_seed(2))
        want, waux = transformer.lm_forward(cfg, whole, tok)
        P = sharding.Placed(mesh, transformer.lm_param_specs(cfg, mesh), [
            transformer.init_lm_params(cfg, torch.Generator().manual_seed(2),
                                       mesh, r) for r in range(4)])
        logits, aux = transformer.lm_forward(cfg, P, tok)
    assert logits.specs == ("data", "model", None)
    close(sharding.gather_placed(logits), want.numpy(), TOL)
    close(aux, waux.numpy(), TOL)
    for r in range(4):
        got = np.load(tmp_path / f"rank{r}.npz")
        close(torch.from_numpy(got["block"]), logits.blocks[r].numpy(), TOL)
        close(torch.from_numpy(got["whole"]),
              sharding.gather_placed(logits).numpy(), TOL)
        close(torch.from_numpy(got["aux"]), aux.numpy(), TOL)


def test_plans_serve_and_restore_over_a_mesh(llama, tmp_path, on_mesh):
    """The ``lm_prefill`` and ``lm_decode`` plans place their inputs by
    their shardings; ``serve.prefill`` and ``serve.serve`` run on the
    registered mesh; ``Checkpointer.restore(shardings=)`` of a checkpoint
    JAX wrote gives each rank ``shard_block`` of every leaf."""
    from repro.train.checkpoint import Checkpointer as JCheckpointer
    from repro_torch.configs.base import ArchBundle, shape
    from repro_torch.configs.registry import ARCHS
    from repro_torch.train import Checkpointer
    jc, tc, jp, tp = llama
    mesh = on_mesh((2, 2))
    b = ARCHS["llama3.2-1b"]
    bundle = ArchBundle(b.arch_id, "lm", tc, (), b.smoke)
    tok = torch.from_numpy(tokens(jc, 2, 16, seed=10))
    want = transformer.lm_forward(tc, tp, tok)[0][:, -1]
    spec = shape("p", "lm_prefill", seq_len=16, global_batch=2)
    plan = steps.build_plan(bundle, spec, mesh)
    got = plan.step(tp, dict(tokens=tok))
    assert isinstance(got, sharding.Placed)
    close(sharding.gather_placed(got), want.numpy(), TOL)
    close(sharding.gather_placed(serve.prefill(tc, tp, tok)), want.numpy(),
          TOL)
    spec = shape("d", "lm_decode", seq_len=8, global_batch=2)
    plan = steps.build_plan(bundle, spec, mesh)
    cache = transformer.init_kv_cache(tc, 2, 8, device=CPU)
    lens = torch.tensor([0, 3], dtype=torch.int32)
    wl, _ = transformer.lm_decode_step(tc, tp, tok[:, :1], tuple(
        c.clone() for c in cache), lens)
    gl, gcache = plan.step(tp, tok[:, :1], cache, lens)
    assert isinstance(gcache, sharding.Placed)
    close(sharding.gather_placed(gl), wl.numpy(), TOL)
    # serve: the same tokens as on one device (f32 logits)
    cfg = dataclasses.replace(serve.PRESETS["lm_tiny"],
                              compute_dtype=torch.float32)
    out, _, _ = serve.serve(cfg, 3, 2, prompt_len=4, gen_len=3, max_len=16,
                            device="cpu")
    ctx.set_dist_mesh(None)
    one, _, _ = serve.serve(cfg, 3, 2, prompt_len=4, gen_len=3, max_len=16,
                            device="cpu")
    assert out == one
    ctx.set_dist_mesh(mesh)
    # a JAX checkpoint restored laid out over the mesh
    tree = jax.tree.map(np.asarray, jp)
    JCheckpointer(tmp_path / "ck").save(3, tree)
    specs = transformer.lm_param_specs(tc, mesh)
    got, _, step = Checkpointer(tmp_path / "ck").restore(
        tree, shardings=(mesh, specs))
    assert step == 3 and isinstance(got, sharding.Placed)
    held_blocks(mesh, transformer.lm_params_from_numpy(tc, tree, CPU),
                got)
