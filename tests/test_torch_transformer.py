"""The port's LM (``repro_torch.models.transformer``, ``launch.serve``)
against the JAX package, on the CPU.

Parameters come from the JAX package's ``init_lm_params`` and are carried
across as numpy; tokens are made with numpy from a seed.  Tolerances:

* f32 (``compute_dtype=float32``), 1e-4 x max(1, max |ref|): JAX's
  attention is swapped, by ``monkeypatch`` in the test, for what the
  port computes in f32: ``flash_attention_xla`` for the Pallas kernel in
  interpret mode and ``decode_attention`` for ``decode_attention_ref``
  (both round to bf16 whatever the compute dtype); the port's own
  ``decode_attention``, a copy of JAX's, is swapped for the same f32
  function.  The JAX source is not edited.
* bf16 (the configs' own compute dtype), 3e-2 x max(1, max |ref|): bf16
  keeps 8 significant bits (a step of 2^-8 = 3.9e-3 relative), and the
  two frameworks round at different places (XLA fuses elementwise chains
  in f32, ``flash_attention_xla`` rounds q * scale and the probabilities
  where the port's kernel keeps f32), so over two layers logits near 4
  differ by up to four bf16 steps (0.06, 1.5e-2 relative); 3e-2 leaves
  twice that.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import lm_archs as jarchs
from repro.kernels.flash_attention.ops import flash_attention as j_flash
from repro.kernels.flash_attention.ref import decode_attention_ref
from repro.launch import serve as jserve
from repro.launch.train import PRESETS as J_PRESETS
from repro.models import transformer as jtr
from repro.models.common import count_params as j_count
from repro_torch.configs import lm_archs
from repro_torch.configs.base import lm_shapes
from repro_torch.launch import serve
from repro_torch.models import transformer
from repro_torch.models.common import count_params

CPU = torch.device("cpu")
DENSE = ["LLAMA32_1B", "QWEN3_1P7B", "STARCODER2_3B"]
ALL = ["PHI35_MOE", "ARCTIC"] + DENSE
TOL = {"f32": 1e-4, "bf16": 3e-2}


def configs(arch, dtype="bf16", smoke=True):
    """The JAX and the port's config of ``arch`` (their fields equal)."""
    j, t = getattr(jarchs, arch), getattr(lm_archs, arch)
    if smoke:
        j, t = jarchs._smoke(j), lm_archs._smoke(t)
    if dtype == "f32":
        j = dataclasses.replace(j, compute_dtype=jnp.float32)
        t = dataclasses.replace(t, compute_dtype=torch.float32)
    dt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
    want = {k: dt.get(v, v) for k, v in dataclasses.asdict(j).items()}
    assert dataclasses.asdict(t) == want
    return j, t


def carried(jcfg, tcfg, seed=0):
    jp = jtr.init_lm_params(jcfg, jax.random.PRNGKey(seed))
    return jp, transformer.lm_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jp), CPU)


def close(got, want, tol):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = max(1.0, float(np.abs(want).max()))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol * scale)


def decode_f32(q, k_cache, v_cache, lengths):
    """``decode_attention_ref`` in torch: every step in f32."""
    B, _, H, dh = q.shape
    G = H // k_cache.shape[2]
    qf = q[:, 0].float() / np.sqrt(dh)
    kf = k_cache.float().repeat_interleave(G, dim=2)
    vf = v_cache.float().repeat_interleave(G, dim=2)
    s = torch.einsum("bhd,bshd->bhs", qf, kf)
    mask = torch.arange(k_cache.shape[1])[None, :] < lengths[:, None]
    s = s.masked_fill(~mask[:, None, :], float("-inf"))
    return torch.einsum("bhs,bshd->bhd", torch.softmax(s, -1), vf)[:, None]


@pytest.fixture
def f32_attention(monkeypatch):
    """Both packages' attention in f32: JAX's through the Pallas kernel
    (interpret mode) and ``decode_attention_ref``, the port's decode
    through ``decode_f32``."""
    monkeypatch.setattr(jtr, "flash_attention_xla",
                        lambda q, k, v, causal=True, chunk=512: j_flash(
                            q, k, v, causal=causal, interpret=True))
    monkeypatch.setattr(jtr, "decode_attention", decode_attention_ref)
    monkeypatch.setattr(transformer, "decode_attention", decode_f32)


def tokens(cfg, B, T, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, (B, T)).astype(np.int32)


# ------------------------------ configs --------------------------------

@pytest.mark.parametrize("arch", ALL)
def test_configs_and_parameter_counts(arch):
    jc, tc = configs(arch, smoke=False)
    assert tc.n_params() == jc.n_params()
    assert tc.n_active_params() == jc.n_active_params()
    assert tc.dh == jc.dh
    js, ts = configs(arch)
    p = transformer.init_lm_params(ts, torch.Generator().manual_seed(0))
    jp = jtr.init_lm_params(js, jax.random.PRNGKey(0))
    # (the analytic n_params leaves out LayerNorm biases, in both)
    assert count_params(p) == j_count(jp)
    assert shapes(p) == shapes(jp)


def shapes(tree):
    return {k: shapes(v) if isinstance(v, dict) else tuple(np.shape(v))
            for k, v in tree.items()}


def test_bundles_and_shapes():
    got = [(b.arch_id, b.family, b.config.name) for b in lm_archs.bundles()]
    want = [(b.arch_id, b.family, b.config.name) for b in jarchs.bundles()]
    assert got == want
    assert [(s.name, s.kind, s.dims) for s in lm_shapes()] == [
        (s.name, s.kind, s.dims) for s in jarchs.lm_shapes()]
    for name, cfg in serve.PRESETS.items():
        dt = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}
        assert dataclasses.asdict(cfg) == {
            k: dt.get(v, v)
            for k, v in dataclasses.asdict(J_PRESETS[name]).items()}


def test_moe_forward_raises_and_bad_trees_are_refused():
    _, tc = configs("PHI35_MOE")
    p = transformer.init_lm_params(tc, torch.Generator().manual_seed(0))
    with pytest.raises(NotImplementedError, match="MoE"):
        transformer.lm_forward(tc, p, torch.zeros((1, 4), dtype=torch.int32))
    _, llama = configs("LLAMA32_1B")
    with pytest.raises(ValueError, match="does not fit"):
        transformer.lm_params_from_numpy(
            llama, {k: v for k, v in p.items()}, CPU)


# ------------------------------ pieces ----------------------------------

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("theta", [1e4, 5e5])
def test_rope_matches_jax(dtype, theta):
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.standard_normal((2, 9, 3, 16)).astype(
        np.float32)).to(dtype)
    pos = torch.from_numpy(rng.integers(0, 3000, (2, 9)).astype(np.int32))
    got = transformer.rope(x, pos, theta)
    want = jtr.rope(jnp.asarray(x.float().numpy()).astype(
        jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32),
        jnp.asarray(pos.numpy()), theta)
    assert got.dtype == dtype
    # the angles are equal to an f32 step; sin/cos of the same angle
    # differ by an f32 step between the two libraries, then round alike
    close(got, want, 1e-5 if dtype == torch.float32 else 1e-2)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_decode_attention_matches_jax(dtype):
    """The port's plain decode attention rounds where JAX's does (q *
    scale, the caches and the probabilities to bf16): the same numbers
    up to the f32 sums' order."""
    rng = np.random.default_rng(3)
    q = rng.standard_normal((3, 1, 8, 32)).astype(np.float32)
    kc, vc = (rng.standard_normal((3, 20, 2, 32)).astype(np.float32)
              for _ in range(2))
    lengths = np.array([1, 9, 20], np.int32)
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, kc, vc))
    got = transformer.decode_attention(tq, tk, tv, torch.from_numpy(lengths))
    jd = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    want = jtr.decode_attention(*(jnp.asarray(t.float().numpy()).astype(jd)
                                  for t in (tq, tk, tv)),
                                jnp.asarray(lengths))
    assert got.dtype == torch.float32
    close(got, want, 1e-5)


# ---------------------------- the model ---------------------------------

@pytest.mark.parametrize("arch", DENSE)
def test_lm_forward_and_loss_f32(arch, f32_attention):
    jc, tc = configs(arch, "f32")
    jp, tp = carried(jc, tc)
    tok = tokens(jc, 2, 24)
    tgt = tokens(jc, 2, 24, seed=1)
    want = jtr.lm_forward(jc, jp, jnp.asarray(tok))[0]
    got = transformer.lm_forward(tc, tp, torch.from_numpy(tok))[0]
    close(got, want, TOL["f32"])
    batch = dict(tokens=tok, targets=tgt)
    close(transformer.lm_loss(tc, tp, {k: torch.from_numpy(v)
                                       for k, v in batch.items()}),
          jtr.lm_loss(jc, jp, {k: jnp.asarray(v) for k, v in batch.items()}),
          TOL["f32"])


@pytest.mark.parametrize("arch", DENSE)
def test_lm_forward_and_loss_bf16(arch):
    jc, tc = configs(arch)
    jp, tp = carried(jc, tc, seed=1)
    tok = tokens(jc, 2, 40, seed=2)
    tgt = tokens(jc, 2, 40, seed=3)
    want = jtr.lm_forward(jc, jp, jnp.asarray(tok))[0]
    got = transformer.lm_forward(tc, tp, torch.from_numpy(tok))[0]
    assert got.dtype == torch.bfloat16
    close(got, want, TOL["bf16"])
    batch = dict(tokens=tok, targets=tgt)
    close(transformer.lm_loss(tc, tp, {k: torch.from_numpy(v)
                                       for k, v in batch.items()}),
          jtr.lm_loss(jc, jp, {k: jnp.asarray(v) for k, v in batch.items()}),
          TOL["bf16"])
    # the module gives the forward's numbers; prefill its last position's
    # (one bf16 product row, up to the matmul's blocking)
    lm = transformer.LM.from_numpy(tc, jax.tree.map(np.asarray, jp), CPU)
    torch.testing.assert_close(lm(torch.from_numpy(tok)), got, rtol=0,
                               atol=0)
    torch.testing.assert_close(
        serve.prefill(tc, tp, torch.from_numpy(tok)).float(),
        got[:, -1].float(), rtol=0, atol=TOL["bf16"])


def teacher_forced(jc, tc, jp, tp, steps=6, max_len=16):
    """``steps`` decode steps over ragged lengths (slot 0 empty, slot 1
    holding 5 positions of earlier keys and values, slot 2 13), the same
    tokens fed to both; the logits of every step and the final caches."""
    B = 3
    rng = np.random.default_rng(4)
    shape = (tc.n_layers, B, max_len, tc.n_kv_heads, tc.dh)
    start = rng.standard_normal((2, *shape)).astype(np.float32)
    lengths = np.array([0, 5, 13], np.int32)
    start[:, :, 0] = 0.0                     # slot 0 holds nothing yet
    jcache = tuple(jnp.asarray(c).astype(jnp.bfloat16) for c in start)
    tcache = tuple(torch.from_numpy(c).bfloat16() for c in start)
    feed = tokens(jc, B, steps, seed=5)
    out = []
    for s in range(steps):
        lens = lengths + s
        jl, jcache = jtr.lm_decode_step(jc, jp, jnp.asarray(feed[:, s:s + 1]),
                                        jcache, jnp.asarray(lens))
        tl, tcache = transformer.lm_decode_step(
            tc, tp, torch.from_numpy(feed[:, s:s + 1]), tcache,
            torch.from_numpy(lens))
        assert tl.dtype == torch.float32 and tl.shape == (B, 1, tc.vocab)
        out.append((tl, jl))
    return out, tcache, jcache


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("arch", DENSE)
def test_decode_teacher_forced_over_ragged_lengths(arch, dtype, request):
    if dtype == "f32":
        request.getfixturevalue("f32_attention")
    jc, tc = configs(arch, dtype)
    jp, tp = carried(jc, tc, seed=2)
    steps, tcache, jcache = teacher_forced(jc, tc, jp, tp)
    for tl, jl in steps:
        close(tl, jl, TOL[dtype])
    for t, j in zip(tcache, jcache):
        # the caches hold bf16: a written key or value may round to the
        # neighbouring bf16 number (2^-8 relative), hence 2e-2
        close(t.float(), np.asarray(j, np.float32), max(TOL[dtype], 2e-2))


def test_decode_rejects_several_tokens_and_drops_writes_past_the_end():
    jc, tc = configs("LLAMA32_1B")
    jp, tp = carried(jc, tc)
    tcache = transformer.init_kv_cache(tc, 2, 4, device=CPU)
    with pytest.raises(ValueError, match=r"q\[:, 0\]"):
        transformer.lm_decode_step(
            tc, tp, torch.zeros((2, 2), dtype=torch.int32), tcache,
            torch.zeros(2, dtype=torch.int32))
    # a slot already at the cache's end: JAX's .at[].set drops the write
    lens = np.array([4, 1], np.int32)
    tok = tokens(jc, 2, 1)
    _, (jk, _) = jtr.lm_decode_step(jc, jp, jnp.asarray(tok),
                                    jtr.init_kv_cache(jc, 2, 4),
                                    jnp.asarray(lens))
    _, (tk, _) = transformer.lm_decode_step(tc, tp, torch.from_numpy(tok),
                                            tcache, torch.from_numpy(lens))
    assert not tk[:, 0].any() and tk[:, 1, 1].any()
    close(tk.float(), np.asarray(jk, np.float32), 2e-2)


def test_entry_points_default_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tc = configs("LLAMA32_1B")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        transformer.init_kv_cache(tc, 1, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        serve.serve(tc, 1, 1)


# ---------------------------- the slice ---------------------------------

def schedule(n_requests, batch, prompt_len, gen_len):
    """``serve``'s slot schedule: for each step and slot, ``None`` or
    (request, whether the step's argmax is emitted as its next token)."""
    slots, remaining, lengths = [None] * batch, [0] * batch, [0] * batch
    submitted = done = 0
    steps = []
    while done < n_requests:
        for b in range(batch):
            if slots[b] is None and submitted < n_requests:
                slots[b], remaining[b], lengths[b] = submitted, \
                    prompt_len + gen_len, 0
                submitted += 1
        row = []
        for b in range(batch):
            if slots[b] is None:
                row.append(None)
                continue
            lengths[b] += 1
            row.append((slots[b], lengths[b] > prompt_len))
            remaining[b] -= 1
            if remaining[b] <= 0:
                slots[b] = None
                done += 1
        steps.append(row)
    return steps


def test_serve_gives_jax_tokens(monkeypatch, capsys):
    """The port's ``serve()`` at lm_tiny, from JAX ``serve()``'s own
    parameters (``init_lm_params(PRNGKey(seed))``), emits JAX's tokens.
    A request is followed up to the first step where JAX's top-2 logit
    margin on its slot falls below the bf16 tolerance (or below twice
    the logits' difference at that step): there the two argmaxes may
    rightly differ, and after it that request's stream parts (the slots
    do not interact).  Until then every step's logits agree
    within the bf16 tolerance and every emitted token is JAX's."""
    seed, n_req, batch, prompt_len, gen_len = 3, 6, 4, 16, 24
    jcfg, tcfg = J_PRESETS["lm_tiny"], serve.PRESETS["lm_tiny"]
    jp = jtr.init_lm_params(jcfg, jax.random.PRNGKey(seed))
    tp = transformer.lm_params_from_numpy(
        tcfg, jax.tree.map(np.asarray, jp), CPU)

    j_logits, t_logits = [], []

    class RecordingJnp:
        """``jnp`` for ``repro.launch.serve``, keeping every step's
        logits as they reach its argmax."""
        def __getattr__(self, name):
            return getattr(jnp, name)

        @staticmethod
        def argmax(x, axis=None):
            j_logits.append(np.asarray(x, np.float32))
            return jnp.argmax(x, axis=axis)

    def recording_step(*a):
        logits, cache = transformer.lm_decode_step(*a)
        t_logits.append(logits[:, -1].numpy())
        return logits, cache

    monkeypatch.setattr(jserve, "jnp", RecordingJnp())
    monkeypatch.setattr(serve, "lm_decode_step", recording_step)
    j_out, _, _ = jserve.serve(jcfg, n_req, batch, prompt_len, gen_len,
                               seed=seed)
    t_out, _, metrics = serve.serve(tcfg, n_req, batch, prompt_len, gen_len,
                                    seed=seed, params=tp, device=CPU)
    plan = schedule(n_req, batch, prompt_len, gen_len)
    assert metrics["steps"] == len(plan) == len(j_logits) == len(t_logits)

    agreed = {r: 0 for r in range(n_req)}
    followed = set(range(n_req))
    for row, jl, tl in zip(plan, j_logits, t_logits):
        for b, slot in enumerate(row):
            if slot is None or slot[0] not in followed:
                continue
            r, emitted = slot
            close(tl[b], jl[b], TOL["bf16"])
            if not emitted:
                continue
            # below the bf16 tolerance, or twice this step's difference
            # (where one flip of the order is possible), the argmax may
            # rightly differ
            top2 = np.sort(jl[b])[-2:]
            limit = max(TOL["bf16"] * max(1.0, float(np.abs(jl[b]).max())),
                        2 * float(np.abs(tl[b] - jl[b]).max()))
            if top2[1] - top2[0] < limit:
                followed.discard(r)
                continue
            assert tl[b].argmax() == jl[b].argmax()
            agreed[r] += 1
    for r in range(n_req):
        assert t_out[r][:agreed[r]] == j_out[r][:agreed[r]]
    if followed == set(range(n_req)):
        assert t_out == j_out
    same = [next((i for i, (a, b) in enumerate(zip(t_out[r], j_out[r]))
                  if a != b), gen_len) for r in range(n_req)]
    with capsys.disabled():
        print(f"\n[serve parity] emitted tokens held to JAX's: "
              f"{sum(agreed.values())} of {n_req * gen_len} (per request "
              f"{list(agreed.values())}, each up to JAX's first top-2 "
              f"margin below the bf16 tolerance); equal in fact: "
              f"{sum(same)} (leading tokens per request {same})")
