"""The port's expert parallelism (``transformer._ffn_moe_ep`` over a
registered ``LocalTiles`` mesh) against the JAX package's ``_ffn_moe_ep``
under ``shard_map`` on 8 fake host devices, on the CPU.

The JAX side runs in one subprocess (the device count locks at JAX's
first init, as in ``tests/test_torch_dist.py``), jitted, on layer 0 of
the phi3.5-moe smoke config widened to 16 experts (``moe_impl="ep"``),
its parameters drawn there and carried across as numpy.  Cases: the
meshes (1, 2), (1, 4) and (2, 2) at capacity factor 1.25 (a rank's
capacity is its own: ``max(ceil(S_loc K cf / E), 8)``) in bf16 and f32,
a 4-token batch at (2, 2) (``(S // n_dp) * K == E // 4``, the edge that
still runs EP), and each of JAX's fallbacks to ``_ffn_moe``: no mesh, S
not a multiple of the dp size, ``(S // n_dp) * K < E // 4``.

Tolerances: f32 1e-5 x max(1, max |ref|); bf16 two bf16 steps of the
largest |out| (each rank's expert products round to bf16 at other places
in the two libraries, its output rounds once to bf16, and the sum over
``model`` rounds once more).  aux: f32 1e-5, bf16 1e-2 (the router
product in bf16 now and then rounds a token's logit to the neighbouring
bf16 number in one library, and where that swaps a near-tie of its first
two experts, the token counts for the other in ``frac_t``: E x gate / S
of aux).  A fallback is the port's ``_ffn_moe`` bit for bit.
"""
import dataclasses
import json
import math
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from repro_torch.configs import lm_archs
from repro_torch.dist import ctx, sharding
from repro_torch.dist.transport import ProcessGroupTiles
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.models import transformer

E_ = 16
# (name, mesh or None, dtype, B, T)
CASES = [("1x2", (1, 2), "bf16", 2, 32), ("1x4", (1, 4), "bf16", 2, 32),
         ("2x2", (2, 2), "bf16", 2, 32), ("1x2_f32", (1, 2), "f32", 2, 32),
         ("1x4_f32", (1, 4), "f32", 2, 32), ("2x2_f32", (2, 2), "f32", 2, 32),
         ("2x2_s4", (2, 2), "bf16", 4, 1),
         ("no_mesh", None, "bf16", 2, 32),
         ("s_odd", (2, 2), "bf16", 1, 33),
         ("few_tokens", (2, 2), "bf16", 2, 1)]
FALLBACK = {"no_mesh", "s_odd", "few_tokens"}

JAX_SCRIPT = textwrap.dedent("""
    import os, json, sys
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    import dataclasses
    import jax, jax.numpy as jnp
    import numpy as np
    from repro.configs import lm_archs
    from repro.dist.ctx import set_dist_mesh
    from repro.launch.mesh import make_host_mesh
    from repro.models import transformer as jtr

    arg = json.loads(sys.stdin.read())
    base = dataclasses.replace(lm_archs._smoke(lm_archs.PHI35_MOE),
                               n_experts=arg["E"], moe_impl="ep")
    p = jtr.init_lm_params(base, jax.random.PRNGKey(0))
    lp = {k: v[0] for k, v in p["layers"].items()}
    out = {f"param/{k}": np.asarray(v) for k, v in lp.items()}
    for name, mesh, dtype, B, T in arg["cases"]:
        cd = jnp.float32 if dtype == "f32" else jnp.bfloat16
        cfg = dataclasses.replace(base, compute_dtype=cd)
        x = np.random.default_rng(B * 1000 + T).standard_normal(
            (B, T, cfg.d_model)).astype(np.float32)
        set_dist_mesh(None if mesh is None else make_host_mesh(*mesh))
        y, aux = jax.jit(lambda lp, x: jtr._ffn_moe_ep(cfg, lp, x))(
            lp, jnp.asarray(x).astype(cd))
        set_dist_mesh(None)
        out[f"{name}/x"] = x
        out[f"{name}/out"] = np.asarray(y.astype(jnp.float32))
        out[f"{name}/aux"] = np.asarray(aux)
    np.savez(arg["path"], **out)
    print("JAX_EP_OK")
""")


@pytest.fixture(scope="module")
def jax_ep(tmp_path_factory):
    """JAX's outputs of every case, and the layer's parameters."""
    path = tmp_path_factory.mktemp("ep") / "jax_ep.npz"
    arg = dict(E=E_, cases=CASES, path=str(path))
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    r = subprocess.run([sys.executable, "-c", JAX_SCRIPT],
                       input=json.dumps(arg), capture_output=True, text=True,
                       timeout=300, env=env)
    assert "JAX_EP_OK" in r.stdout, r.stdout[-2000:] + r.stderr[-3000:]
    return dict(np.load(path))


def config(dtype="bf16"):
    cfg = dataclasses.replace(lm_archs._smoke(lm_archs.PHI35_MOE),
                              n_experts=E_, moe_impl="ep")
    if dtype == "f32":
        cfg = dataclasses.replace(cfg, compute_dtype=torch.float32)
    return cfg


def layer_params(ref) -> dict:
    return {k[6:]: torch.from_numpy(v) for k, v in ref.items()
            if k.startswith("param/")}


def run(cfg, lp, x, mesh):
    ctx.set_dist_mesh(mesh)
    transformer.reset_moe_dropped()
    try:
        return transformer._ffn_moe_ep(cfg, lp, x)
    finally:
        ctx.set_dist_mesh(None)


def tolerance(want, dtype) -> float:
    top = float(np.abs(want).max())
    if dtype == "f32":
        return 1e-5 * max(1.0, top)
    return 2 * 2.0 ** (math.floor(math.log2(top)) - 7)


@pytest.mark.parametrize("case", [c for c in CASES if c[0] not in FALLBACK],
                         ids=lambda c: c[0])
def test_ep_on_local_tiles_equals_jax(jax_ep, case):
    name, shape, dtype, _, _ = case
    cfg = config(dtype)
    lp = layer_params(jax_ep)
    x = torch.from_numpy(jax_ep[f"{name}/x"]).to(cfg.compute_dtype)
    got, aux = run(cfg, lp, x, make_host_mesh(*shape, device="cpu"))
    want = jax_ep[f"{name}/out"]
    assert got.dtype == cfg.compute_dtype and got.shape == x.shape
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tolerance(want, dtype))
    np.testing.assert_allclose(float(aux), float(jax_ep[f"{name}/aux"]),
                               rtol=0, atol=1e-5 if dtype == "f32" else 1e-2)
    # at data 1 the 64 tokens overflow a cap of 10 (dropped pairs held to
    # JAX's); a rank's cap has a floor of 8, so 2 tokens a shard drop none
    drops = transformer.moe_dropped()
    # each dp shard's pairs past a rank's cap, from the routing (held to
    # JAX's in test_torch_moe.py), summed over the shards and experts
    S, n_dp = x.shape[0] * x.shape[1], shape[0]
    S_loc = S // n_dp
    _, _, topi, _ = transformer._route(cfg, lp, x.reshape(S, -1))
    cap = max(math.ceil(S_loc * cfg.top_k * cfg.capacity_factor
                        / cfg.n_experts), 8)
    assert drops == sum(int((torch.bincount(
        topi[d * S_loc:(d + 1) * S_loc].reshape(-1), minlength=cfg.n_experts)
        - cap).clamp_min(0).sum()) for d in range(n_dp))
    assert drops > 0 if shape[0] == 1 else drops == 0 or name != "2x2_s4"


@pytest.mark.parametrize("name", sorted(FALLBACK))
def test_ep_falls_back_to_ffn_moe_on_jax_conditions(jax_ep, name):
    _, shape, dtype, B, T = next(c for c in CASES if c[0] == name)
    cfg = config(dtype)
    lp = layer_params(jax_ep)
    x = torch.from_numpy(jax_ep[f"{name}/x"]).to(cfg.compute_dtype)
    mesh = None if shape is None else make_host_mesh(*shape, device="cpu")
    got, aux = run(cfg, lp, x, mesh)
    dense, dense_aux = transformer._ffn_moe(cfg, lp, x)
    assert torch.equal(got, dense) and torch.equal(aux, dense_aux)
    want = jax_ep[f"{name}/out"]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0,
                               atol=tolerance(want, dtype))


def test_ep_equals_ffn_moe_where_nothing_drops(jax_ep):
    """Two functions that agree where no token is dropped: at capacity
    factor 16 (no rank and no expert drops) EP on every mesh is the dense
    dispatch within a bf16 step of the largest |out| (EP adds f32 gates
    in f32 and sums bf16 over ``model``; the dense path rounds the gates
    to bf16 and sums in f32)."""
    cfg = dataclasses.replace(config(), capacity_factor=16.0)
    lp = layer_params(jax_ep)
    x = torch.from_numpy(jax_ep["1x2/x"]).to(cfg.compute_dtype)
    dense, dense_aux = transformer._ffn_moe(cfg, lp, x)
    for shape in ((1, 2), (1, 4), (2, 2), (1, 1)):
        got, aux = run(cfg, lp, x, make_host_mesh(*shape, device="cpu"))
        assert transformer.moe_dropped() == 0
        assert torch.equal(aux, dense_aux)
        np.testing.assert_allclose(got.float().numpy(),
                                   dense.float().numpy(), rtol=0,
                                   atol=tolerance(dense.float().numpy(),
                                                  "bf16") / 2)


def test_ep_blocks_cut_by_the_sharding_rule():
    """Each rank's experts by ``lm_param_shardings``' spec: ``model`` cuts
    the experts, dp cuts D; ``init_lm_params(mesh=, rank=)`` draws that
    block bit for bit; EP refuses a block where it needs the whole leaf,
    and a mesh the experts or D do not split over."""
    cfg = dataclasses.replace(config(), n_layers=2)
    full = transformer.init_lm_params(cfg, torch.Generator().manual_seed(3))
    mesh = make_host_mesh(2, 2, device="cpu")
    for name, shp in (("moe_wi", (2, 8, 32, 128)), ("moe_wo",
                                                    (2, 8, 128, 32))):
        spec = sharding.lm_param_shardings(mesh, full)["layers"][name]
        assert spec == ((None, "model", "data", None) if name == "moe_wi"
                        else (None, "model", None, "data"))
        for r in range(4):
            blk = transformer.init_lm_params(
                cfg, torch.Generator().manual_seed(3), mesh, r)
            assert blk["layers"][name].shape == shp
            assert torch.equal(blk["layers"][name], sharding.shard_block(
                full["layers"][name], mesh, spec, r))
            assert torch.equal(blk["embed"], sharding.shard_block(
                full["embed"], mesh,
                sharding.lm_param_shardings(mesh, full)["embed"], r))
    lp = transformer._layer_params(blk, 0)
    x = torch.zeros((2, 8, cfg.d_model), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="neither the whole leaf"):
        run(cfg, lp, x, mesh)
    lp = transformer._layer_params(full, 0)
    with pytest.raises(ValueError, match="do not split"):
        run(cfg, lp, x, make_host_mesh(1, 3, device="cpu"))


def test_ep_over_processes_needs_data_1():
    """Over processes at ``data`` > 1 EP runs on a whole batch, each
    process routing its dp slice of it (it once raised here): this
    process as rank 0 of a stand-in four-process group at (2, 2), each
    of its collectives answered with what rank 0 receives over
    ``LocalTiles``, sends what rank 0 sends there and returns what rank 0
    returns, bit for bit."""
    cfg = config()
    lp = transformer._layer_params(transformer.init_lm_params(
        cfg, torch.Generator().manual_seed(0)), 0)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (2, 8, cfg.d_model)).astype(np.float32)).bfloat16()
    local = make_host_mesh(2, 2, device="cpu")
    lt, calls = local.transport, []

    def record(fn):
        def call(mesh, axes, blocks, *dim):
            out = fn(mesh, axes, blocks, *dim)
            calls.append((blocks[0], out[0]))
            return out
        return call
    lt.axis_sum, lt.axis_gather = record(lt.axis_sum), record(lt.axis_gather)
    want, waux = run(cfg, lp, x, local)
    assert len(calls) == 4      # model sum, two dp sums, the dp gather
    replies = iter(calls)

    def answer(mesh, axes, blocks, *dim):
        sent, reply = next(replies)
        assert torch.equal(blocks[0], sent)
        return [reply]
    tr = object.__new__(ProcessGroupTiles)
    tr.world, tr.rank, tr.local_ranks = 4, 0, (0,)
    tr.axis_sum = tr.axis_gather = answer
    got, aux = run(cfg, lp, x, ctx.Mesh((2, 2), ("data", "model"), tr))
    assert next(replies, None) is None
    assert torch.equal(got, want) and torch.equal(aux, waux)


def test_axis_groups_sums_and_gathers_on_local_tiles():
    mesh = make_host_mesh(2, 4, device="cpu")
    assert mesh.axis_groups(("model",)) == [(0, 1, 2, 3), (4, 5, 6, 7)]
    assert mesh.axis_groups(("data",)) == [(0, 4), (1, 5), (2, 6), (3, 7)]
    assert [mesh.axis_index(r, ("data", "model")) for r in range(8)] == \
        list(range(8))
    blocks = [torch.full((2, 3), float(r)) for r in range(8)]
    sums = mesh.transport.axis_sum(mesh, ("model",), blocks)
    assert [float(s[0, 0]) for s in sums] == [6.0] * 4 + [22.0] * 4
    got = mesh.transport.axis_gather(mesh, ("data",), blocks, 1)
    assert got[5].shape == (2, 6)
    assert got[5][0].tolist() == [1.0] * 3 + [5.0] * 3
