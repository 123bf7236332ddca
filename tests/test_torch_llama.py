"""Llama of the port (ray_tpu_torch.models.llama), its sampler and the
paged-cache bookkeeping, against the JAX package.

Both packages get the same parameters (the JAX package's
``init_params(PRNGKey(0))`` for llama-tiny, carried across by
``convert.py``) and the same inputs (numpy, from a seed). Everything is
fp32 here, so the tolerances only absorb summation order: 1e-5 relative
on logits, the loss and each gradient's largest entry; the paged and
dense cache paths rtol/atol 1e-5, as the JAX package's own paged tests
hold them. The sampler must draw the same tokens as ``jax.random``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ray_tpu.llm import paged as jpaged
from ray_tpu.models import llama as jl
from ray_tpu_torch import device as tdevice
from ray_tpu_torch import random as trandom
from ray_tpu_torch.llm import paged as tpaged
from ray_tpu_torch.llm import sampling
from ray_tpu_torch.models import llama as tl
from ray_tpu_torch.models.convert import (llama_params_from_numpy,
                                          llama_tree_to_numpy,
                                          tensor_from_numpy)

JCFG = jl.CONFIGS["llama-tiny"]
TCFG = tl.CONFIGS["llama-tiny"]
PS = 8  # page size: 16 pages per 128-token sequence
PPS = JCFG.max_seq // PS


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: at llama-tiny size more buy little time and
    crowd the test processes running beside this one."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _full_fp32():
    """fp32 products at full precision whatever the process was left with
    (see ``device.full_fp32``)."""
    with tdevice.full_fp32():
        yield


@pytest.fixture(scope="module")
def params():
    p, _ = jl.init_params(jax.random.PRNGKey(0), JCFG)
    return p


def _model(params, cfg=TCFG):
    model = tl.Llama(cfg, device="cpu")
    model.load_state_dict(llama_params_from_numpy(
        jax.tree.map(np.asarray, params), cfg))
    return model


@pytest.fixture(scope="module")
def model(params):
    return _model(params).requires_grad_(False)


def _tokens(shape, seed=0):
    return np.random.default_rng(seed).integers(
        1, JCFG.vocab_size, shape).astype(np.int32)


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    return np.abs(got - want).max() / max(np.abs(want).max(), 1e-12)


def test_config_table_matches():
    assert set(tl.CONFIGS) == set(jl.CONFIGS)
    for name, jc in jl.CONFIGS.items():
        tc = tl.CONFIGS[name]
        for f in ("vocab_size", "max_seq", "num_layers", "num_heads",
                  "num_kv_heads", "d_model", "d_mlp", "rope_theta", "remat",
                  "head_dim"):
            assert getattr(tc, f) == getattr(jc, f), (name, f)
        assert str(tc.dtype).split(".")[-1] == jnp.dtype(jc.dtype).name


@pytest.mark.parametrize("batched", [False, True])
def test_rope_matches_jax(batched):
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 4, 9, 16)).astype(np.float32)
    positions = (rng.integers(0, 2048, (2, 9)) if batched
                 else np.arange(5, 14)).astype(np.int32)
    want = jl.rope(jnp.asarray(x), jnp.asarray(positions), 10000.0)
    got = tl.rope(torch.from_numpy(x), torch.from_numpy(positions), 10000.0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)


def test_repeat_kv_matches_jax():
    x = np.random.default_rng(4).standard_normal((2, 3, 5, 4)).astype(
        np.float32)
    np.testing.assert_array_equal(
        tl._repeat_kv(torch.from_numpy(x), 4).numpy(),
        np.asarray(jl._repeat_kv(jnp.asarray(x), 4)))


def test_forward_logits_match_jax(params, model):
    tokens = _tokens((2, 33))
    want = jl.forward(params, jnp.asarray(tokens), JCFG)
    with torch.no_grad():
        got = model(torch.from_numpy(tokens))
    assert got.dtype == torch.float32
    assert _rel(got.numpy(), want) < 1e-5


@pytest.mark.parametrize("remat", [False, True])
def test_loss_and_grads_match_jax(params, remat):
    """Every gradient within 1e-5 of its largest entry; remat recomputes
    each block in the backward (jax.checkpoint / torch checkpoint)."""
    import dataclasses

    jcfg = dataclasses.replace(JCFG, remat=remat)
    tcfg = dataclasses.replace(TCFG, remat=remat)
    tokens = _tokens((2, 25), seed=1)
    loss_j, grads_j = jax.value_and_grad(
        lambda p: jl.loss_fn(p, {"tokens": jnp.asarray(tokens)}, jcfg))(
            params)
    model = _model(params, tcfg)
    loss_t = model.loss_fn({"tokens": torch.from_numpy(tokens)})
    loss_t.backward()
    np.testing.assert_allclose(float(loss_t.detach()), float(loss_j),
                               rtol=1e-5)
    grads_t = llama_tree_to_numpy(
        {n: p.grad for n, p in model.named_parameters()}, tcfg)
    for path, gj in jax.tree_util.tree_flatten_with_path(grads_j)[0]:
        gt = grads_t
        for key in path:
            gt = gt[key.key]
        assert _rel(gt, gj) < 1e-5, jax.tree_util.keystr(path)


def test_convert_round_trip_bit_exact(params):
    tree = jax.tree.map(lambda x: np.asarray(x.astype(jnp.bfloat16)), params)
    state = llama_params_from_numpy(tree, TCFG)
    assert state["blocks.1.w_up"].dtype == torch.bfloat16
    back = llama_tree_to_numpy(state, TCFG)
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        got = back
        for key in path:
            got = got[key.key]
        np.testing.assert_array_equal(got, leaf.astype(np.float32))
    t = tensor_from_numpy(tree["blocks"]["wq"])
    np.testing.assert_array_equal(t.view(torch.int16).numpy(),
                                  tree["blocks"]["wq"].view(np.int16))


def test_generate_greedy_matches_jax(params, model):
    prompt = _tokens((2, 7), seed=5)
    want = np.asarray(jl.generate(params, prompt, JCFG, max_new=12))
    got = tl.generate(model, torch.from_numpy(prompt), max_new=12)
    np.testing.assert_array_equal(got.numpy(), want)


def test_generate_sampled_matches_jax(params, model):
    """split + batched categorical (one key draws [B, V] noise)."""
    prompt = _tokens((2, 5), seed=6)
    want = np.asarray(jl.generate(params, prompt, JCFG, max_new=10,
                                  temperature=0.8,
                                  key=jax.random.PRNGKey(5)))
    got = tl.generate(model, torch.from_numpy(prompt), max_new=10,
                      temperature=0.8, key=trandom.prng_key(5))
    np.testing.assert_array_equal(got.numpy(), want)


# -- KV-cache paths ----------------------------------------------------------

def test_dense_cache_paths_match_jax(params, model):
    """prefill_chunk, decode_slots and decode_slots_with_prefill on the
    dense cache against the JAX package's, chained over a few steps."""
    rng = np.random.default_rng(9)
    prompt = _tokens((13,), seed=9)
    buf = np.zeros((16,), np.int32)
    buf[:13] = prompt
    jc = jl.init_kv_cache(JCFG, 3)
    tc = tl.init_kv_cache(TCFG, 3, "cpu")
    lj, jc = jl.prefill_chunk(params, jc, jnp.asarray(buf), 1, 0, JCFG,
                              last_idx=12)
    lt, tc = tl.prefill_chunk(model, tc, torch.from_numpy(buf), 1, 0,
                              last_idx=12)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-5)
    for step in range(3):
        toks = rng.integers(1, JCFG.vocab_size, 3).astype(np.int32)
        pos = np.asarray([JCFG.max_seq - 1, 13 + step, JCFG.max_seq - 1],
                         np.int32)
        lj, jc = jl.decode_slots(params, jc, jnp.asarray(toks),
                                 jnp.asarray(pos), JCFG)
        lt, tc = tl.decode_slots(model, tc, torch.from_numpy(toks),
                                 torch.from_numpy(pos).long())
        np.testing.assert_allclose(lt[1].numpy(), np.asarray(lj[1]),
                                   rtol=1e-5, atol=1e-5)
    # Fused: slot 1 decodes at 16 while slot 2 prefills a chunk.
    toks = np.asarray([0, 7, 0], np.int32)
    pos = np.asarray([JCFG.max_seq - 1, 16, JCFG.max_seq - 1], np.int32)
    chunk = _tokens((8,), seed=10)
    dj, pj, jc = jl.decode_slots_with_prefill(
        params, jc, jnp.asarray(toks), jnp.asarray(pos), jnp.asarray(chunk),
        2, 0, 5, JCFG)
    dt, pt, tc = tl.decode_slots_with_prefill(
        model, tc, torch.from_numpy(toks), torch.from_numpy(pos).long(),
        torch.from_numpy(chunk), 2, 0, 5)
    np.testing.assert_allclose(dt[1].numpy(), np.asarray(dj[1]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tc["k"].numpy()[:, 1:], np.asarray(jc["k"])
                               [:, 1:], rtol=1e-5, atol=1e-5)


def _scattered_tables():
    tables = np.zeros((3, PPS), np.int32)
    tables[1] = np.arange(1, PPS + 1)[::-1]
    tables[2] = np.arange(PPS + 1, 2 * PPS + 1)
    return tables


@pytest.mark.parametrize("as_tensors", [False, True])
def test_paged_paths_match_jax(params, model, as_tensors):
    """prefill_chunk_paged, decode_slots_paged and
    decode_slots_with_prefill_paged on a scattered page table against the
    JAX package's; the scalars as ints or as one-element tensors (how
    the engine's CUDA graphs pass them)."""
    scalar = ((lambda v: torch.tensor([v])) if as_tensors
              else (lambda v: v))
    tables = _scattered_tables()
    tt = torch.from_numpy(tables).long()
    jc = jl.init_paged_kv_cache(JCFG, 2 * PPS + 1, PS)
    tc = tl.init_paged_kv_cache(TCFG, 2 * PPS + 1, PS, "cpu")
    prompt = _tokens((13,), seed=11)
    buf = np.zeros((16,), np.int32)
    buf[:13] = prompt
    lj, jc = jl.prefill_chunk_paged(params, jc, jnp.asarray(tables),
                                    jnp.asarray(buf), 1, 0, 13, JCFG, PS)
    lt, tc = tl.prefill_chunk_paged(model, tc, tt, torch.from_numpy(buf),
                                    scalar(1), scalar(0), scalar(13), PS)
    np.testing.assert_allclose(lt.numpy(), np.asarray(lj), rtol=1e-5,
                               atol=1e-5)
    tok = np.int32(np.argmax(np.asarray(lj)))
    for step in range(3):
        toks = np.asarray([0, tok, 0], np.int32)
        pos = np.asarray([JCFG.max_seq, 13 + step, JCFG.max_seq], np.int32)
        lj, jc = jl.decode_slots_paged(params, jc, jnp.asarray(tables),
                                       jnp.asarray(toks), jnp.asarray(pos),
                                       JCFG, PS)
        lt, tc = tl.decode_slots_paged(model, tc, tt, torch.from_numpy(toks),
                                       torch.from_numpy(pos).long(), PS)
        np.testing.assert_allclose(lt[1].numpy(), np.asarray(lj[1]),
                                   rtol=1e-5, atol=1e-5)
        tok = np.int32(np.argmax(np.asarray(lj[1])))
    # Fused: slot 1 decodes while slot 2 prefills a chunk straddling a
    # page boundary (p0 4, 6 valid of 8).
    toks = np.asarray([0, tok, 0], np.int32)
    pos = np.asarray([JCFG.max_seq, 16, JCFG.max_seq], np.int32)
    chunk = _tokens((8,), seed=12)
    dj, pj, jc = jl.decode_slots_with_prefill_paged(
        params, jc, jnp.asarray(tables), jnp.asarray(toks), jnp.asarray(pos),
        jnp.asarray(chunk), 2, 4, 6, JCFG, PS)
    dt, pt, tc = tl.decode_slots_with_prefill_paged(
        model, tc, tt, torch.from_numpy(toks), torch.from_numpy(pos).long(),
        torch.from_numpy(chunk), scalar(2), scalar(4), scalar(6), PS)
    np.testing.assert_allclose(dt[1].numpy(), np.asarray(dj[1]), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(pt.numpy(), np.asarray(pj), rtol=1e-5,
                               atol=1e-5)
    # Every live page agrees; the scratch page 0 holds garbage in both.
    np.testing.assert_allclose(tc["kv"].numpy()[:, :, 1:],
                               np.asarray(jc["kv"])[:, :, 1:], rtol=1e-5,
                               atol=1e-5)


def test_copy_and_write_pages_match_jax():
    rng = np.random.default_rng(13)
    kv = rng.standard_normal((2, 2, 6, PS, 2, 16)).astype(np.float32)
    src, dst = np.asarray([1, 4], np.int32), np.asarray([5, 2], np.int32)
    want = jl.copy_pages({"kv": jnp.asarray(kv)}, jnp.asarray(src),
                         jnp.asarray(dst))["kv"]
    got = tl.copy_pages({"kv": torch.from_numpy(kv.copy())}, src, dst)["kv"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    values = rng.standard_normal((2, 2, 2, PS, 2, 16)).astype(np.float32)
    want = jl.write_pages({"kv": jnp.asarray(kv)}, jnp.asarray(dst),
                          jnp.asarray(values))["kv"]
    got = tl.write_pages({"kv": torch.from_numpy(kv.copy())}, dst,
                         torch.from_numpy(values))["kv"]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_paged_cache_layout_heads_minor():
    cache = tl.init_paged_kv_cache(TCFG, 7, PS, "cpu")
    assert set(cache) == {"kv"}
    assert tuple(cache["kv"].shape) == tuple(
        jl.init_paged_kv_cache(JCFG, 7, PS)["kv"].shape)
    assert not cache["kv"].any(), "the pool must start zeroed"
    assert tl.PAGED_KV_AXES == jl.PAGED_KV_AXES
    with pytest.raises(ValueError):
        tl.init_paged_kv_cache(TCFG, 7, 12, "cpu")


def test_rules_without_a_mesh_are_the_identity(model):
    """Rules on parameters that are not placed change nothing, as
    ``constrain`` in the JAX package: forward logits and a paged decode
    step equal those without rules (sharded paths:
    tests/test_torch_llm_tp.py)."""
    tokens = torch.from_numpy(_tokens((1, 12)))
    with torch.no_grad():
        torch.testing.assert_close(model(tokens, rules={"kv": "tp"}),
                                   model(tokens), rtol=0, atol=0)
    tables = torch.arange(1, PPS + 1)[None]
    logits = []
    for rules in (None, {"kv": "tp", "heads": "tp"}):
        cache = tl.init_paged_kv_cache(TCFG, PPS + 1, PS, "cpu")
        logits.append(tl.decode_slots_paged(
            model, cache, tables, tokens[0, :1], torch.zeros(1).long(), PS,
            rules=rules)[0])
    torch.testing.assert_close(logits[0], logits[1], rtol=0, atol=0)


def test_llama_needs_cuda_unless_cpu_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.Llama(TCFG)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tl.init_paged_kv_cache(TCFG, 3, PS)


# -- the sampler ---------------------------------------------------------------

SEEDS = [0, 4242, 2**31 - 1, -7]


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_words_match_jax(seed):
    """PRNGKey (negative seeds too), fold_in, split and uniform bits."""
    key = trandom.prng_key(seed)
    want = np.asarray(jax.random.key_data(jax.random.PRNGKey(seed)))
    assert [int(w) for w in key] == want.tolist()
    jkey = jax.random.fold_in(jax.random.PRNGKey(seed), 123)
    k = trandom.fold_in(key, 123)
    assert [int(w) for w in k] == np.asarray(
        jax.random.key_data(jkey)).tolist()
    s0, s1 = trandom.split(k)
    want = np.asarray(jax.random.key_data(jax.random.split(jkey)))
    assert np.array_equal(np.stack([s0.numpy(), s1.numpy()], -1), want)
    tiny = np.finfo(np.float32).tiny
    want = np.asarray(jax.random.uniform(jkey, (3, 700), minval=tiny))
    got = trandom.uniform(k, (3, 700), minval=tiny).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("vocab", [512, 32000])
def test_sampler_tokens_match_jax(vocab):
    """The engine's draw: token qpos of seed s at temperature t, as
    ``jax.random.categorical(fold_in(PRNGKey(s), qpos), lg / t)``, and
    the argmax where t == 0. Seeds 0, 4242, 2**31 - 1, -7; qpos 0-200;
    temperatures 0.3, 0.8, 1.5 (and 0 on some rows). At vocab 512 every
    position is drawn at every temperature; at 32000 the temperatures
    take turns along the positions (the noise of 201 x 32000 draws is
    the cost, and it does not depend on the temperature)."""
    def one(lg, t, s, q):
        key = jax.random.fold_in(jax.random.PRNGKey(s), q)
        return jax.random.categorical(key, lg / jnp.maximum(t, 1e-6))

    jsample = jax.jit(jax.vmap(one))
    rng = np.random.default_rng(vocab)
    qpos = np.arange(201, dtype=np.int32)
    crossed = vocab <= 512
    for seed in SEEDS:
        for temp in ((0.3, 0.8, 1.5) if crossed else (None,)):
            logits = (rng.standard_normal((201, vocab)) * 2).astype(
                np.float32)
            temps = (np.full(201, temp, np.float32) if crossed else
                     np.resize(np.float32([0.3, 0.8, 1.5]), 201))
            temps[::50] = 0.0  # greedy rows
            seeds = np.full(201, seed, np.int32)
            want = np.where(temps > 0,
                            np.asarray(jsample(logits, temps, seeds, qpos)),
                            logits.argmax(-1))
            got = sampling.sample(torch.from_numpy(logits),
                                  torch.from_numpy(temps),
                                  torch.from_numpy(seeds),
                                  torch.from_numpy(qpos))
            assert got.dtype == torch.int32
            np.testing.assert_array_equal(got.numpy(), want,
                                          err_msg=f"seed {seed} t {temp}")


def test_gumbel_noise_close_to_jax():
    """Same uniforms bit for bit, and the Gumbel noise too: both logs are
    XLA's (``xla_log``)."""
    tiny = np.finfo(np.float32).tiny
    jkey = jax.random.fold_in(jax.random.PRNGKey(1), 7)
    key = trandom.fold_in(trandom.prng_key(1), 7)
    np.testing.assert_array_equal(
        trandom.uniform(key, (100_000,), minval=tiny).numpy(),
        np.asarray(jax.random.uniform(jkey, (100_000,), minval=tiny)))
    want = np.asarray(jax.random.gumbel(jkey, (100_000,)))
    got = trandom.gumbel(key, (100_000,)).numpy()
    np.testing.assert_array_equal(got, want)


def test_xla_log_matches_jnp_log_bit_for_bit():
    """``xla_log`` against ``jnp.log`` on 1,041,031 fp32 values: random
    ones in (0, 1) and over every binade, the 81 floats around each power
    of two and around each sqrt(1/2) * 2**e (where the mantissa's fold
    switches), ``tiny``, 1, the largest float below 1 and the largest
    finite one."""
    f32 = np.float32
    rng = np.random.default_rng(1)
    parts = [rng.uniform(0, 1, 500_000).astype(f32),
             (2.0 ** rng.uniform(-126, 128, 500_000)).astype(f32)]
    exps = np.arange(-126, 128)
    for base in (2.0 ** exps, np.sqrt(0.5) * 2.0 ** exps):
        base = base.astype(f32).view(np.int32)
        parts += [(base + k).view(f32) for k in range(-40, 41)]
    parts.append(np.array([np.finfo(f32).tiny, 1, np.nextafter(f32(1), 0),
                           np.finfo(f32).max], f32))
    x = np.concatenate(parts)
    x = x[np.isfinite(x) & (x >= np.finfo(f32).tiny)]
    assert x.size >= 1_000_000
    np.testing.assert_array_equal(trandom.xla_log(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.log(x)))


@pytest.mark.parametrize("a,b,c,want", [
    # a * b + c just below the midpoint between two fp32 values, then just
    # above it, then negated: float64 rounds each sum onto the midpoint.
    (1 + 2 ** -15, 2 ** -24 * (1 - 2 ** -15), 1 + 2 ** -23, 1 + 2 ** -23),
    (1 + 2 ** -10, 2 ** -24 * (1 - 2 ** -10 + 2 ** -20), 1.0, 1 + 2 ** -23),
    (-(1 + 2 ** -15), 2 ** -24 * (1 - 2 ** -15), -(1 + 2 ** -23),
     -(1 + 2 ** -23)),
])
def test_fma_to_odd_rounds_once(a, b, c, want):
    """``xla_log``'s fused multiply-add where a float64 sum rounded again
    to fp32 would round twice, and wrongly."""
    f32 = lambda x, dt=torch.float32: torch.tensor([x], dtype=dt)
    assert all(np.float32(x) == x for x in (a, b, c))
    twice = (f32(a).double() * b + c).float().item()
    assert twice != want
    assert trandom._fma_to_odd(f32(a), f32(b, torch.float64),
                               f32(c)).item() == want


def test_argmax_ties_go_to_the_first_index():
    logits = torch.zeros((2, 8))
    logits[:, 3] = logits[:, 5] = 1.0
    got = sampling.sample(logits, torch.zeros(2), torch.zeros(2).int(),
                          torch.zeros(2).long())
    assert got.tolist() == [3, 3]


# -- PagePool / RadixIndex: the port's copy against the JAX package's ---------

@pytest.mark.parametrize("pkg", [tpaged, jpaged], ids=["port", "jax"])
def test_page_pool_refcounts_and_lru(pkg):
    pool = pkg.PagePool(6)  # scratch + 5
    assert pool.free_count == 5 and pool.used_count == 1
    a, b = pool.alloc(), pool.alloc()
    assert 0 not in (a, b), "scratch page must never be allocated"
    pool.ref(a)
    assert not pool.unref(a)  # still borrowed
    assert pool.unref(a) and pool.free_count == 4
    assert pool.unref(b) and pool.free_count == 5
    order = [pool.alloc() for _ in range(5)]
    assert order[-2:] == [a, b]
    assert pool.used_count + pool.free_count == pool.num_pages


@pytest.mark.parametrize("pkg", [tpaged, jpaged], ids=["port", "jax"])
def test_radix_match_insert_evict(pkg):
    pool = pkg.PagePool(8)
    idx = pkg.RadixIndex(pool, 4)
    prompt = list(range(1, 11))
    pages = [pool.alloc(), pool.alloc()]
    assert idx.insert(prompt, pages) == 2
    assert idx.match(prompt) == (pages, None)
    assert idx.match(prompt + [99, 98, 97])[0] == pages
    full, partial = idx.match(prompt[:6] + [55, 44, 33, 22])
    assert full == pages[:1] and partial == (pages[1], 2)
    for p in pages:
        pool.unref(p)
    assert idx.evict(1) == 1
    assert idx.match(prompt)[0] == pages[:1]
    assert idx.clear() == 1
    assert pool.used_count == 1


def test_pool_and_radix_random_ops_match_jax():
    """One seeded random sequence of alloc/ref/unref/insert/match/evict/
    clear against both packages' classes: every result and count equal."""
    rng = np.random.default_rng(17)
    pools = [tpaged.PagePool(24), jpaged.PagePool(24)]
    idxs = [tpaged.RadixIndex(pools[0], 4), jpaged.RadixIndex(pools[1], 4)]
    held = []  # pages our side holds a reference on (same in both)
    prompts = [rng.integers(0, 3, 12).tolist() for _ in range(6)]
    for _ in range(400):
        op = rng.integers(0, 7)
        if op == 0 and pools[0].free_count:
            got = [p.alloc() for p in pools]
            assert got[0] == got[1]
            held.append(got[0])
        elif op == 1 and held:
            pg = held[rng.integers(len(held))]
            for p in pools:
                p.ref(pg)
            held.append(pg)
        elif op == 2 and held:
            pg = held.pop(rng.integers(len(held)))
            assert pools[0].unref(pg) == pools[1].unref(pg)
        elif op == 3 and len(held) >= 3:
            prompt = prompts[rng.integers(len(prompts))]
            pages = held[:3]
            assert idxs[0].insert(prompt, pages) == idxs[1].insert(prompt,
                                                                   pages)
        elif op == 4:
            prompt = prompts[rng.integers(len(prompts))][:rng.integers(1,
                                                                       13)]
            assert idxs[0].match(prompt) == idxs[1].match(prompt)
        elif op == 5:
            n = int(rng.integers(1, 4))
            assert idxs[0].evict(n) == idxs[1].evict(n)
        elif op == 6 and rng.random() < 0.05:
            assert idxs[0].clear() == idxs[1].clear()
        assert (pools[0].free_count, pools[0].used_count, len(idxs[0])) == \
            (pools[1].free_count, pools[1].used_count, len(idxs[1]))
        assert [pools[0].refcount(i) for i in range(24)] == \
            [pools[1].refcount(i) for i in range(24)]
