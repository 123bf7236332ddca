"""The port's CUDA kernels against their plain versions, on the card.

Every test here needs an NVIDIA card and skips without one (marker
``cuda``). The file imports neither JAX nor ``ray_tpu``, so it also runs
on a machine that has only PyTorch:

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest -q
"""

import pytest
import torch

from ray_tpu_torch import device as tdevice
from ray_tpu_torch.ops import attention as tattn


@pytest.fixture(autouse=True)
def _full_fp32():
    """fp32 products at full precision whatever the process was left with:
    the plain versions are the reference here (see ``device.full_fp32``)."""
    with tdevice.full_fp32():
        yield


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d,causal,dtype", [
    (256, 256, 64, True, torch.bfloat16),
    (200, 333, 64, False, torch.bfloat16),
    (128, 128, 128, True, torch.bfloat16),
    (256, 256, 64, True, torch.float16),
    (200, 333, 128, False, torch.bfloat16),  # non-causal Sq != Sk at D 128
    (128, 384, 64, True, torch.bfloat16),    # causal Sq < Sk
    (129, 129, 64, True, torch.bfloat16),    # one tile plus one
    (200, 130, 128, True, torch.bfloat16),   # short query tile, causal Sq > Sk, D 128
    (40, 40, 64, True, torch.bfloat16),      # one short tile
    (256, 100, 64, False, torch.float16),    # Sk not a multiple of the key tile
])
def test_cuda_kernels_match_plain(cuda, sq, sk, d, causal, dtype):
    """Kernels against the plain versions on the same 16-bit inputs;
    2e-2 of the largest entry (bf16 keeps 8 bits)."""
    g = torch.Generator(device=cuda).manual_seed(0)
    mk = lambda s: torch.randn((2, 3, s, d), generator=g, device=cuda,
                               dtype=dtype)
    q, k, v, do = mk(sq), mk(sk), mk(sk), mk(sq)
    scale = d ** -0.5
    tattn.reset_launch_counts()
    o, lse = tattn.flash_fwd(q, k, v, causal, scale)
    ro, rlse = tattn.mha_reference_with_lse(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = tattn.flash_bwd_dkdv(q, k, v, do, lse, delta, causal, scale)
    dq = tattn.flash_bwd_dq(q, k, v, do, lse, delta, causal, scale)
    rdk, rdv = tattn.flash_bwd_dkdv_reference(q, k, v, do, lse, delta,
                                              causal, scale)
    rdq = tattn.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                       scale)
    torch.cuda.synchronize()
    for a, r in ((o, ro), (dq, rdq), (dk, rdk), (dv, rdv)):
        err = (a.float() - r.float()).abs().max() / r.float().abs().max()
        assert err < 2e-2
    assert (lse - rlse).abs().max() < 1e-4
    assert [f.launches for f in tattn.KERNEL_WRAPPERS] == [1, 1, 1]


@pytest.mark.cuda
@pytest.mark.parametrize("d", [64, 128])
def test_cuda_dq_is_deterministic(cuda, d):
    """K3 writes each dq row from one block, without atomics: two launches
    on the same inputs give the same bits."""
    g = torch.Generator(device=cuda).manual_seed(1)
    q, k, v, do = (torch.randn((2, 3, 300, d), generator=g, device=cuda,
                               dtype=torch.bfloat16) for _ in range(4))
    scale = d ** -0.5
    o, lse = tattn.flash_fwd(q, k, v, True, scale)
    delta = (do.float() * o.float()).sum(-1)
    first = tattn.flash_bwd_dq(q, k, v, do, lse, delta, True, scale)
    second = tattn.flash_bwd_dq(q, k, v, do, lse, delta, True, scale)
    torch.cuda.synchronize()
    assert torch.equal(first.view(torch.int16), second.view(torch.int16))


# -- the LayerNorm kernels (csrc/layer_norm.cu) --------------------------------

F32, BF16, FP16 = torch.float32, torch.bfloat16, torch.float16
# The kernels and the plain version both compute in fp32 and round once to
# the output's type; their fp32 values differ only by the order of the sums
# (and rsqrt against 1/sqrt), a few fp32 units. So a 16-bit output differs
# by one unit in its last place at most, 2^-7 of the largest entry in bf16
# and 2^-10 in fp16, and an fp32 one by far less than 1e-5 of it (dscale
# and dbias sum up to 65,536 rows, in fp32 both ways).
LN_TOL = {F32: 1e-5, BF16: 2 ** -7, FP16: 2 ** -10}


def _ln_inputs(cuda, rows, d, dtype, pdtype, seed=0):
    g = torch.Generator(device=cuda).manual_seed(seed)
    mk = lambda *s: torch.randn(s, generator=g, device=cuda)
    x = (mk(rows, d) * 3 + 1).to(dtype)
    scale = (1 + 0.5 * mk(d)).to(pdtype)
    bias = (0.5 * mk(d)).to(pdtype)
    return x, scale, bias, mk(rows, d).to(dtype)


def _ln_rel(got, ref) -> float:
    return ((got.float() - ref.float()).abs().max()
            / ref.float().abs().max()).item()


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d", [(16384, 1600), (65536, 1024), (4096, 384),
                                    (4096, 768), (4096, 1280), (1000, 1001)])
@pytest.mark.parametrize("dtype,pdtype", [(BF16, BF16), (BF16, F32),
                                          (FP16, FP16), (FP16, F32),
                                          (F32, F32)])
def test_cuda_layer_norm_matches_plain(cuda, rows, d, dtype, pdtype):
    """y, dx, dscale and dbias through ``layer_norm`` (the kernels, by
    autograd) against the plain version's autograd on the same inputs,
    within LN_TOL; the two cells' shapes ([16384, 1600], [65536, 1024]),
    ViT's, gpt2-124m's, gpt2-774m's and MoE's widths, and a d no vector
    divides. One forward and one backward call: the counts rise by one
    each and no call takes the plain version."""
    from ray_tpu_torch.ops import norm

    x, scale, bias, dy = _ln_inputs(cuda, rows, d, dtype, pdtype)
    xs = [t.clone().requires_grad_() for t in (x, scale, bias)]
    refs = [t.clone().requires_grad_() for t in (x, scale, bias)]
    norm.reset_counts()
    y = norm.layer_norm(*xs)
    y.backward(dy)
    ry = norm.layer_norm_reference(*refs)
    ry.backward(dy)
    torch.cuda.synchronize()
    assert norm.counts() == (2, 0)
    assert (norm.layer_norm_fwd.launches, norm.layer_norm_bwd.launches) == \
        (1, 1)
    assert y.dtype == dtype and xs[0].grad.dtype == dtype
    assert _ln_rel(y, ry) <= LN_TOL[dtype]
    assert _ln_rel(xs[0].grad, refs[0].grad) <= LN_TOL[dtype]
    for got, ref in zip(xs[1:], refs[1:]):
        assert got.grad.dtype == pdtype
        assert _ln_rel(got.grad, ref.grad) <= LN_TOL[pdtype]


@pytest.mark.cuda
@pytest.mark.parametrize("rows,d,dtype", [(16384, 1600, BF16),
                                          (65536, 1024, BF16),
                                          (1000, 1001, F32)])
def test_cuda_layer_norm_backward_is_deterministic(cuda, rows, d, dtype):
    """The backward sums dscale and dbias in a fixed order, without
    atomics: two runs on the same inputs give the same bits."""
    from ray_tpu_torch.ops import norm

    x, scale, bias, dy = _ln_inputs(cuda, rows, d, dtype, dtype, seed=3)
    _, mean, rstd = norm.layer_norm_fwd(x, scale, bias)
    first = norm.layer_norm_bwd(dy, x, scale, mean, rstd)
    second = norm.layer_norm_bwd(dy, x, scale, mean, rstd)
    torch.cuda.synchronize()
    for a, b in zip(first, second):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("policy,per_layer", [("none", 4), ("mem2", 6)])
def test_cuda_gpt2_layer_norms_take_the_kernels(cuda, policy, per_layer):
    """A GPT-2 step on the card: ln1 and ln2 forward and backward a layer,
    again forward under mem2's recompute, and lnf; every call through the
    kernels."""
    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.ops import norm

    cfg = gpt2.GPT2Config(vocab_size=512, max_seq=128, num_layers=3,
                          num_heads=2, d_model=128, remat_policy=policy)
    model = gpt2.GPT2(cfg, torch.Generator().manual_seed(0)).to(cuda).to(
        torch.bfloat16)
    tokens = torch.randint(0, 512, (2, 129), device=cuda)
    norm.reset_counts()
    loss = model.loss_fn({"tokens": tokens})
    loss.backward()
    torch.cuda.synchronize()
    assert torch.isfinite(loss)
    assert norm.counts() == (per_layer * 3 + 2, 0)


@pytest.mark.cuda
def test_cuda_layer_norm_refuses_what_it_does_not_take(cuda):
    from ray_tpu_torch.ops import norm

    x, scale, bias, _ = _ln_inputs(cuda, 4, 4097, BF16, BF16)
    with pytest.raises(ValueError, match="d 1 to 4096"):
        norm.layer_norm(x, scale, bias)
    x, scale, bias, _ = _ln_inputs(cuda, 4, 64, BF16, FP16)
    with pytest.raises(TypeError, match="dtype or fp32"):
        norm.layer_norm_fwd(x, scale, bias)


# -- the serving path (models/llama, llm/) on the card ------------------------

def _tiny_llama(cuda, dtype=torch.bfloat16, max_seq=256):
    from ray_tpu_torch.models import llama

    cfg = llama.LlamaConfig(vocab_size=512, max_seq=max_seq, num_layers=2,
                            num_heads=4, num_kv_heads=2, d_model=128,
                            d_mlp=344, dtype=dtype, remat=False)
    gen = torch.Generator(device=cuda).manual_seed(0)
    return llama.Llama(cfg, gen, cuda).to(dtype).requires_grad_(False)


@pytest.mark.cuda
def test_cuda_entry_points_default_to_the_card(cuda):
    from ray_tpu_torch.llm.engine import SlotEngine
    from ray_tpu_torch.llm.serve import LLMServer
    from ray_tpu_torch.models import llama

    model = llama.Llama(llama.CONFIGS["llama-tiny"])
    assert model.wte.device.type == "cuda"
    engine = SlotEngine(model, num_slots=1, chunk=8)
    assert engine._cache["kv"].device.type == "cuda"
    server = LLMServer(num_slots=1, chunk=8)
    try:
        assert server.engine._cache["kv"].device.type == "cuda"
    finally:
        server.engine.stop()


@pytest.mark.cuda
def test_cuda_sampler_matches_cpu(cuda):
    """The seeded sampler draws the same tokens on the card as on the CPU
    (threefry is integer arithmetic; the Gumbel noise may differ by an ulp
    of log, which moves no token here)."""
    import numpy as np

    from ray_tpu_torch.llm import sampling

    rng = np.random.default_rng(0)
    for vocab in (512, 32000):
        n = 201
        logits = torch.from_numpy(
            (rng.standard_normal((n, vocab)) * 2).astype(np.float32))
        temps = torch.from_numpy(
            rng.choice([0.0, 0.3, 0.8, 1.5], n).astype(np.float32))
        seeds = torch.from_numpy(rng.choice(
            [0, 4242, 2**31 - 1, -7], n).astype(np.int32))
        qpos = torch.arange(n)
        want = sampling.sample(logits, temps, seeds, qpos)
        got = sampling.sample(logits.to(cuda), temps.to(cuda),
                              seeds.to(cuda), qpos.to(cuda))
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_cuda_paged_matches_dense_bf16(cuda):
    """Paged prefill and decode against the dense cache in bf16 on the
    card: 2e-2 of the largest logit."""
    from ray_tpu_torch.models import llama

    model = _tiny_llama(cuda)
    cfg, ps = model.cfg, 16
    pps = cfg.max_seq // ps
    g = torch.Generator(device=cuda).manual_seed(1)
    prompt = torch.randint(1, cfg.vocab_size, (37,), device=cuda, generator=g)
    paged = llama.init_paged_kv_cache(cfg, 2 * pps + 1, ps, cuda)
    dense = llama.init_kv_cache(cfg, 2, cuda)
    tables = torch.zeros((2, pps), dtype=torch.int64, device=cuda)
    tables[1] = torch.arange(pps, 0, -1, device=cuda)
    buf = torch.zeros((48,), dtype=torch.int64, device=cuda)
    buf[:37] = prompt
    lg_p, _ = llama.prefill_chunk_paged(model, paged, tables, buf, 1, 0, 37,
                                        ps)
    lg_d, _ = llama.prefill_chunk(model, dense, buf, 1, 0, last_idx=36)

    def rel(a, b):
        return ((a - b).abs().max() / b.abs().max()).item()

    assert rel(lg_p, lg_d) < 2e-2
    tok = lg_p.argmax()
    for step in range(4):
        pos = torch.tensor([cfg.max_seq, 37 + step], device=cuda)
        both = torch.stack([torch.zeros_like(tok), tok])
        lg_p, _ = llama.decode_slots_paged(model, paged, tables, both, pos,
                                           ps)
        lg_d, _ = llama.decode_slots(model, dense, both,
                                     pos.clamp_max(cfg.max_seq - 1))
        assert rel(lg_p[1], lg_d[1]) < 2e-2
        tok = lg_p[1].argmax()


@pytest.mark.cuda
def test_cuda_engine_fetch_overlaps_the_next_block(cuda):
    """Lag-1: when step() returns, the block it dispatched is still in
    flight and the previous block's tokens are delivered. A sleep kernel
    queued ahead of the step holds the new block back; a fetch that
    synchronized the stream would have waited for it."""
    from ray_tpu_torch.llm.engine import SlotEngine

    engine = SlotEngine(_tiny_llama(cuda), num_slots=2, chunk=8,
                        page_size=8, decode_block=4, device=cuda)
    h = engine.submit([3, 141, 59, 26, 5], max_new=64)
    while len(h._tokens) < 5:  # past prefill, into steady decode blocks
        engine.step()
    assert engine._inflight is not None
    torch.cuda.synchronize()
    before = len(h._tokens)
    torch.cuda._sleep(2_000_000_000)  # ~1 s of one SM's clock
    engine.step()
    in_flight = not engine._inflight[3].query()
    delivered = len(h._tokens) - before
    torch.cuda.synchronize()
    assert in_flight, "the block dispatched by step() already finished"
    assert delivered == 4, "the previous block's tokens were not delivered"
    while not h._done.is_set():
        engine.step()
    assert len(h.result(timeout=0).tokens) == 64


@pytest.mark.cuda
def test_cuda_engine_graphs_match_eager_paths(cuda):
    """The engine replays each block as a CUDA graph on the card. fp32
    weights: seeded and greedy tokens equal to the engine run eagerly on
    the CPU with the same weights, greedy ones equal to ``generate``
    (dense, eager) on the card. Staggered joins with mixed sampling, a
    chunked prompt, decode blocks of 4 and a last greedy request alone
    run through both block graphs (with the prompt chunk and decode
    only)."""
    from ray_tpu_torch.llm.engine import SlotEngine
    from ray_tpu_torch.models import llama

    model = _tiny_llama(cuda, dtype=torch.float32)
    cpu_model = _tiny_llama(cuda, dtype=torch.float32).cpu()
    cpu_model.load_state_dict(model.state_dict())
    g = torch.Generator().manual_seed(2)
    prompts = [torch.randint(1, 512, (n,), generator=g).tolist()
               for n in (5, 19, 3, 11)]
    kw = dict(num_slots=3, chunk=8, page_size=8, decode_block=4)
    tokens = {}
    for name, m, dev in (("cuda", model, cuda), ("cpu", cpu_model, "cpu")):
        engine = SlotEngine(m, device=dev, **kw)
        handles = []
        for i, p in enumerate(prompts):
            handles.append(engine.submit(
                p, max_new=10, temperature=0.8 if i % 2 else 0.0,
                seed=4242 + i))
            engine.step()
        while not all(h._done.is_set() for h in handles):
            engine.step()
        handles.append(engine.submit(prompts[0], max_new=10))
        while not handles[-1]._done.is_set():
            engine.step()
        tokens[name] = [h.result(timeout=0).tokens for h in handles]
        if name == "cuda":
            assert sorted(engine._graphs) == [False, True]
    assert tokens["cuda"] == tokens["cpu"]
    for i in (0, 2):
        ref = llama.generate(model, torch.tensor([prompts[i]], device=cuda),
                             max_new=10)
        assert tokens["cuda"][i] == ref[0, len(prompts[i]):].tolist()
    assert tokens["cuda"][4] == tokens["cuda"][0]


# -- remat and on-device PPO on the card --------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("policy,k1_per_layer", [("mem2", 1), ("mem", 1),
                                                 ("dots_attn", 1),
                                                 ("full", 2), ("dots", 2)])
def test_cuda_remat_kernel_launches(cuda, policy, k1_per_layer):
    """One training step at gpt2-774m's depth (36 layers, narrow): K1
    launches once a layer where the policy keeps attention (36 under
    mem2) and twice where the backward recomputes it (72 under full and
    dots); K2 and K3 once a layer under every policy. The loss and every
    gradient equal the same step without remat (bf16: 2e-2 of each
    gradient's largest entry)."""
    from ray_tpu_torch.models import gpt2

    grads, losses = {}, {}
    for pol in (policy, "none"):
        cfg = gpt2.GPT2Config(vocab_size=512, max_seq=128, num_layers=36,
                              num_heads=2, d_model=128, remat_policy=pol)
        model = gpt2.GPT2(cfg, torch.Generator().manual_seed(0)).to(
            cuda).to(torch.bfloat16)
        tokens = torch.randint(0, 512, (2, 129), device=cuda,
                               generator=torch.Generator(
                                   device=cuda).manual_seed(1))
        tattn.reset_launch_counts()
        loss = model.loss_fn({"tokens": tokens})
        loss.backward()
        torch.cuda.synchronize()
        counts = [f.launches for f in tattn.KERNEL_WRAPPERS]
        expect = [36 * (k1_per_layer if pol == policy else 1), 36, 36]
        assert counts == expect, (pol, counts)
        losses[pol] = loss.item()
        grads[pol] = [p.grad.float() for p in model.parameters()]
    assert abs(losses[policy] - losses["none"]) < 1e-3
    for a, b in zip(grads[policy], grads["none"]):
        assert ((a - b).abs().max() / b.abs().max().clamp_min(1e-12)) < 2e-2


@pytest.mark.cuda
def test_cuda_threefry_and_env_match_cpu(cuda):
    """Draws (split, uniform, choice, permutation at 32768) and three
    atari_sim steps, resets included: bit-equal on the card and on the
    CPU for the same keys and actions."""
    from ray_tpu_torch import random as trandom
    from ray_tpu_torch.rllib import ondevice

    cpu = torch.device("cpu")

    def draws(d):
        key = trandom.prng_key(77, d)
        keys = trandom.split(key, 16)
        vals = torch.tensor([-2.0, -1.0, 1.0, 2.0], device=d)
        return [torch.stack(keys, -1),
                trandom.uniform(keys, (64, 2), 20.0, 60.0),
                trandom.uniform(keys, (64, 4), -0.05, 0.05),
                trandom.choice(key, vals, (64, 2)),
                trandom.permutation(trandom.split(key, 2), 32768)]

    for a, b in zip(draws(cuda), draws(cpu)):
        assert torch.equal(a.cpu(), b)
    envs = [ondevice.atari_sim(32, d) for d in (cuda, cpu)]
    key = trandom.prng_key(3)
    states = []
    for env in envs:
        state, _ = env.reset(tuple(w.to(env.device) for w in key))
        state["t"][:8] = 998
        states.append(state)
    g = torch.Generator().manual_seed(4)
    for _ in range(3):
        key = trandom.take(trandom.split(key), 1)
        actions = torch.randint(0, 6, (32,), generator=g)
        outs = []
        for i, env in enumerate(envs):
            d = env.device
            states[i], *out = env.step(states[i], actions.to(d),
                                       tuple(w.to(d) for w in key))
            outs.append(out)
        for a, b in zip(*outs):
            assert torch.equal(a.cpu(), b)
        for k, v in states[1].items():
            assert torch.equal(states[0][k].cpu(), v)


@pytest.mark.cuda
@pytest.mark.parametrize("env_name", ["JaxAtariSim", "JaxCartPole"])
def test_cuda_ppo_graph_replay_matches_eager(cuda, env_name):
    """One iteration replayed from the captured CUDA graph against one
    eager iteration from the same state: the same actions, parameters and
    metrics within 1e-3 relative (the conv backward may sum in another
    order)."""
    from ray_tpu_torch.rllib import ondevice
    from ray_tpu_torch.rllib.sample_batch import ACTIONS

    algo = ondevice.OnDevicePPO(ondevice.ENVS[env_name](16), rollout_length=8,
                                minibatches=2, num_sgd_iter=2)
    first = algo.iterate()  # eager, then the capture
    assert algo._graph is not None
    assert all(torch.isfinite(v) for v in first.values())
    snap = algo.snapshot()
    graph = {k: v.item() for k, v in algo.iterate().items()}
    acts = algo.trajectory[ACTIONS].clone()
    after = algo.snapshot()
    algo.restore(snap)
    eager = {k: v.item() for k, v in algo.iterate(graph=False).items()}
    assert torch.equal(algo.trajectory[ACTIONS], acts)
    for a, b in zip(after, algo.snapshot()):
        if a.is_floating_point():
            err = (a - b).abs().max() / b.abs().max().clamp_min(1e-12)
            assert err < 1e-3
        else:
            assert torch.equal(a, b)
    for k, v in eager.items():
        assert abs(graph[k] - v) <= 1e-3 * max(abs(v), 1e-6), k


@pytest.mark.cuda
def test_cuda_ppo_entry_points_default_to_the_card(cuda):
    from ray_tpu_torch.rllib import ondevice

    algo = ondevice.OnDevicePPO(ondevice.cartpole(4), rollout_length=4,
                                minibatches=1, num_sgd_iter=1)
    assert all(p.device.type == "cuda" for p in algo.params.values())
    m = algo.train_iteration()
    assert m["timesteps_this_iter"] == 16


# -- the attention route (fault C3), ViT on the card ----------------------------

@pytest.mark.cuda
def test_cuda_fp32_llama_runs_the_general_kernels(cuda):
    """llama-tiny (fp32, head_dim 16): the Hopper kernels take neither, so
    every attention call on the card runs the general kernels (K4 in the
    forward, K5 and K6 in the backward, one each a layer); loss and
    gradients equal the CPU's (full fp32 on both: 1e-5 relative on the
    loss, 1e-4 of each gradient's largest entry)."""
    import copy

    from ray_tpu_torch.models import llama

    cfg = llama.CONFIGS["llama-tiny"]
    cpu = llama.Llama(cfg, torch.Generator().manual_seed(0), "cpu")
    card = copy.deepcopy(cpu).to(cuda)
    tokens = torch.randint(0, cfg.vocab_size, (2, 33),
                           generator=torch.Generator().manual_seed(1))
    losses = {}
    for name, model in (("cpu", cpu), ("card", card)):
        tattn.reset_launch_counts()
        loss = model.loss_fn({"tokens": tokens.to(
            next(model.parameters()).device)})
        loss.backward()
        losses[name] = loss.item()
        n = cfg.num_layers if name == "card" else 0
        assert [f.launches for f in tattn.GENERAL_WRAPPERS] == [n, n, n]
        assert [f.launches for f in tattn.KERNEL_WRAPPERS] == [0, 0, 0]
    assert abs(losses["card"] - losses["cpu"]) <= 1e-5 * abs(losses["cpu"])
    for a, b in zip(card.parameters(), cpu.parameters()):
        err = (a.grad.cpu() - b.grad).abs().max()
        assert err <= 1e-4 * b.grad.abs().max() + 1e-9


def _misaligned(x: torch.Tensor, elems: int) -> torch.Tensor:
    """``x`` copied to an address ``elems`` elements past an allocation's
    start: a contiguous view aligned to less than 16 bytes."""
    if not elems:
        return x
    buf = torch.empty(x.numel() + elems, dtype=x.dtype, device=x.device)
    out = buf[elems:].view(x.shape)
    out.copy_(x)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("sq,sk,d,causal,dtype,offset", [
    (64, 64, 16, True, torch.float32, 0),       # llama-tiny's head
    (200, 130, 64, True, torch.float32, 0),     # causal Sq > Sk, fp32 D 64
    (130, 200, 128, False, torch.float32, 0),   # fp32 at D 128
    (100, 100, 32, False, torch.bfloat16, 0),
    (70, 150, 80, True, torch.float16, 0),      # causal Sq < Sk, D not /32
    (48, 48, 256, True, torch.float32, 0),      # the largest head_dim
    (33, 33, 1, True, torch.float32, 0),
    (8192, 8192, 64, True, torch.float32, 0),   # bench_ring_parity's rows
    (1024, 1024, 80, True, torch.float16, 0),   # K4's fp16 timing shape
    (200, 130, 64, True, torch.float32, 1),     # misaligned: 4-byte copies
    (100, 150, 48, True, torch.bfloat16, 1),    # misaligned: element copies
])
def test_cuda_general_kernels_match_plain(cuda, sq, sk, d, causal, dtype,
                                          offset):
    """K4-K6 against the plain versions on the same inputs: fp32 within
    1e-5 of the largest entry (fp32 sums in another order), 16-bit within
    2e-2 (bf16 keeps 8 bits); the Hopper kernels are not launched. With
    ``offset``, q, k, v and dO are views that many elements off 16-byte
    alignment, which the general kernels take."""
    g = torch.Generator(device=cuda).manual_seed(0)
    mk = lambda s: _misaligned(torch.randn((2, 3, s, d), generator=g,
                                           device=cuda, dtype=dtype), offset)
    q, k, v, do = mk(sq), mk(sk), mk(sk), mk(sq)
    scale = d ** -0.5
    tattn.reset_launch_counts()
    o, lse = tattn.flash_fwd_general(q, k, v, causal, scale)
    ro, rlse = tattn.mha_reference_with_lse(q, k, v, causal, scale)
    delta = (do.float() * o.float()).sum(-1)
    dk, dv = tattn.flash_bwd_dkdv_general(q, k, v, do, lse, delta, causal,
                                          scale)
    dq = tattn.flash_bwd_dq_general(q, k, v, do, lse, delta, causal, scale)
    rdk, rdv = tattn.flash_bwd_dkdv_reference(q, k, v, do, lse, delta,
                                              causal, scale)
    rdq = tattn.flash_bwd_dq_reference(q, k, v, do, lse, delta, causal,
                                       scale)
    torch.cuda.synchronize()
    tol = 1e-5 if dtype == torch.float32 else 2e-2
    for a, r in ((o, ro), (dq, rdq), (dk, rdk), (dv, rdv)):
        err = (a.float() - r.float()).abs().max() / r.float().abs().max()
        assert err < tol
    assert (lse - rlse).abs().max() < 1e-4
    assert [f.launches for f in tattn.GENERAL_WRAPPERS] == [1, 1, 1]
    assert [f.launches for f in tattn.KERNEL_WRAPPERS] == [0, 0, 0]


@pytest.mark.cuda
def test_cuda_general_kernels_refuse_head_dim_over_256(cuda):
    q = torch.zeros((1, 1, 8, 288), device=cuda)
    with pytest.raises(ValueError, match="head_dim 1 to 256"):
        tattn.flash_attention(q, q, q)


@pytest.mark.cuda
def test_cuda_tiny_vit_step(cuda):
    """A tiny ViT (head_dim 64, S = 65, remat on) trains a step on the
    card: K1 twice a layer (forward and recompute), K2 and K3 once, no
    general kernel; the bf16 logits within 5e-2 of an fp32 CPU evaluation of
    the same weights (relative to the largest logit)."""
    import copy
    import dataclasses

    from ray_tpu_torch.models import vit
    from ray_tpu_torch.train.optim import default_optimizer
    from ray_tpu_torch.train.step import build_train

    cfg = vit.ViTConfig(image_size=32, patch_size=4, num_layers=2,
                        num_heads=2, d_model=128, d_mlp=256, num_classes=10)

    def init_fn(g):
        model = vit.ViT(cfg, g)
        with torch.no_grad():
            model.head_w.normal_(0.0, 0.02, generator=g)
        return model

    init, step = build_train(init_fn, lambda m, b: m.loss_fn(b),
                             optimizer=default_optimizer(warmup=1),
                             master_fp32=True)
    model, opt, n = init(0)
    g = torch.Generator().manual_seed(2)
    batch = {"image": torch.randn((8, 32, 32, 3), generator=g),
             "label": torch.randint(0, 10, (8,), generator=g)}
    ref = copy.deepcopy(model).float().cpu()
    ref.cfg = dataclasses.replace(cfg, dtype=torch.float32)
    with torch.no_grad():
        got = model(batch["image"].to(cuda)).float().cpu()
        want = ref(batch["image"])
    assert (got - want).abs().max() / want.abs().max() < 5e-2
    tattn.reset_launch_counts()
    model, opt, n, met = step(model, opt, n, batch)
    torch.cuda.synchronize()
    assert torch.isfinite(met["loss"]) and n == 1
    assert [f.launches for f in tattn.KERNEL_WRAPPERS] == [4, 2, 2]
    assert [f.launches for f in tattn.GENERAL_WRAPPERS] == [0, 0, 0]


@pytest.mark.cuda
def test_cuda_mesh_of_one_step_matches_build_train(cuda):
    """A world of one on NCCL (in-process KV, ``Bootstrap``,
    ``MeshSpec(dp=1).build()``): three ``build_sharded_train`` steps of a
    tiny bf16 GPT-2 (head dim 64: K1-K3, one each a layer and step) give
    ``build_train``'s losses from the same seed, within 1e-3."""
    import torch.distributed as dist

    from ray_tpu_torch.models import gpt2
    from ray_tpu_torch.parallel.bootstrap import Bootstrap, InMemoryKV
    from ray_tpu_torch.parallel.mesh import MeshSpec
    from ray_tpu_torch.parallel.sharding import prune_rules_for_mesh
    from ray_tpu_torch.train.optim import adamw_lowmem
    from ray_tpu_torch.train.step import build_sharded_train, build_train

    cfg = gpt2.GPT2Config(vocab_size=512, max_seq=128, num_layers=2,
                          num_heads=2, d_model=128, attention_impl="flash")
    tokens = torch.randint(0, 512, (4, 129), device=cuda,
                           generator=torch.Generator(device=cuda).manual_seed(0))
    losses = {}
    bs = Bootstrap(InMemoryKV(), world_size=1, session="cuda-test")
    bs.claim_rank()
    bs.initialize_torch("nccl")
    try:
        mesh = MeshSpec(dp=1).build()
        rules = prune_rules_for_mesh(mesh)
        sharded = build_sharded_train(
            lambda g: gpt2.GPT2(cfg, g), lambda m, b: m.loss_fn(b, rules),
            mesh, optimizer=adamw_lowmem(1e-3), master_fp32=True)[:2]
        plain = build_train(lambda g: gpt2.GPT2(cfg, g),
                            lambda m, b: m.loss_fn(b),
                            optimizer=adamw_lowmem(1e-3), master_fp32=True)
        for name, (init, step_fn) in (("sharded", sharded),
                                      ("plain", plain)):
            state = init(0)
            tattn.reset_launch_counts()
            losses[name] = []
            for _ in range(3):
                *state, m = step_fn(*state, {"tokens": tokens})
                losses[name].append(m["loss"].item())
            assert [f.launches for f in tattn.KERNEL_WRAPPERS] == [6, 6, 6]
            assert all(f.launches == 0 for f in tattn.GENERAL_WRAPPERS)
    finally:
        dist.destroy_process_group()
    assert max(abs(a - b) for a, b in zip(losses["sharded"],
                                          losses["plain"])) < 1e-3


@pytest.mark.cuda
def test_cuda_moe_layer_matches_cpu(cuda):
    """One MoE FFN (fp32, 8 experts, top-2, 2048 tokens at d 256): the
    card routes every token as the CPU does; output and aux within 1e-4
    of the largest CPU entry."""
    from ray_tpu_torch.parallel.moe import moe_ffn_local, router_topk

    g = torch.Generator().manual_seed(0)
    x = torch.randn(2048, 256, generator=g)
    ws = [torch.randn(s, generator=g) * 0.05
          for s in ((256, 8), (8, 256, 1024), (8, 1024, 256))]
    res = {}
    for dev in ("cpu", cuda):
        w = [t.to(dev) for t in ws]
        idx = router_topk(x.to(dev) @ w[0], 2)[1]
        out, aux = moe_ffn_local(x.to(dev), *w, num_experts=8, top_k=2,
                                 axis_name=None)
        res[str(dev)] = (idx.cpu(), out.cpu(), aux.cpu())
    (ic, oc, ac), (ig, og, ag) = res["cpu"], res["cuda"]
    assert torch.equal(ic, ig)
    assert (og - oc).abs().max() / oc.abs().max() < 1e-4
    assert abs(ag.item() - ac.item()) < 1e-4 * abs(ac.item())


# -- the actor-based RLlib learners -------------------------------------------

def _rl_config(case):
    """A small configuration of each actor-based algorithm (local mode)."""
    from ray_tpu_torch.rllib import (A2CConfig, APPOConfig, DQNConfig,
                                     ImpalaConfig, PPOConfig)

    lstm = {"use_lstm": True, "lstm_cell_size": 32, "fcnet_hiddens": (32,)}
    if case in ("ppo", "ppo_lstm"):
        cfg = PPOConfig().rollouts(num_envs_per_worker=4,
                                   rollout_fragment_length=32)
        cfg.training(sgd_minibatch_size=32, num_sgd_iter=2)
        if case == "ppo_lstm":
            cfg.environment("RepeatPrevObs").training(model=lstm)
        return cfg
    if case == "a2c":
        return A2CConfig().rollouts(num_envs_per_worker=4)
    if case in ("impala", "impala_lstm", "appo"):
        cfg = (ImpalaConfig() if case != "appo" else APPOConfig())
        cfg.rollouts(num_envs_per_worker=4, rollout_fragment_length=16)
        cfg.training(num_batches_per_iter=2)
        if case == "impala_lstm":
            cfg.training(model=lstm)
        return cfg
    cfg = DQNConfig().rollouts(num_envs_per_worker=4,
                               rollout_fragment_length=16)
    cfg.policy_hidden = (64, 64)
    return cfg.training(learning_starts=64, num_updates_per_iter=2,
                        train_batch_size=32)


def _tensors(tree):
    """Every tensor of nested tuples, lists and dicts, in order."""
    from ray_tpu_torch.rllib.algorithm import tree_map

    found = []
    tree_map(found.append, tree)
    return found


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["ppo", "ppo_lstm", "a2c", "impala",
                                  "impala_lstm", "appo", "dqn"])
def test_cuda_learner_update_matches_cpu(cuda, case):
    """``build()`` with no device puts the learner on the card (every
    parameter and optimizer-state tensor) and the worker's policy on the
    CPU; the first learner update of a ``train()``, replayed from the same
    parameters, optimizer state, batch and key on the card and on the CPU
    (fp32): the loss within 1e-5 relative, the updated parameters within
    1e-4 of the parameters' norm (the L2 norm of the difference over all
    leaves; Adam's first steps move a parameter by about lr whatever its
    gradient's size, so an element whose gradient is near zero may step
    either way)."""
    from ray_tpu_torch.rllib.algorithm import tree_map

    algo = _rl_config(case).build()
    calls, update = [], algo._update

    def recorded(*args):
        if not calls:
            calls.append(tree_map(lambda t: t.detach().cpu().clone(), args))
        return update(*args)

    algo._update = recorded
    for _ in range(8):
        result = algo.train()
        if calls:
            break
    assert calls and result["timesteps_total"] > 0
    assert all(t.device.type == "cuda" for t in
               _tensors(algo.params) + _tensors(algo.opt_state))
    assert all(p.device.type == "cpu" for p in
               algo.workers.local_worker.policy.params.values())
    outs = {}
    for dev in ("cpu", "cuda"):
        args = tree_map(lambda t: t.to(dev, copy=True), calls[0])
        params = {k: v.requires_grad_() for k, v in args[0].items()}
        out = update(params, *args[1:])
        outs[dev] = [t.detach().cpu() for t in _tensors(out[0])], [
            t.detach().cpu() for t in _tensors(out[2:])]
    (pc, mc), (pg, mg) = outs["cpu"], outs["cuda"]
    diff = torch.sqrt(sum(((a - b) ** 2).sum() for a, b in zip(pg, pc)))
    norm = torch.sqrt(sum((b ** 2).sum() for b in pc))
    assert diff / norm < 1e-4
    loss_c, loss_g = mc[0], mg[0]
    assert loss_c.ndim == 0
    assert abs(loss_g.item() - loss_c.item()) <= 1e-5 * abs(loss_c.item())
    algo.stop()


# -- the scan's kernels (csrc/ssd_*.cu, ops/ssd.py) --------------------------

# Relative to each output's largest entry: the kernels' products take bf16
# operands (dy, the states and the decays times C B^T rounded once, at the
# product), 2-6e-3 read against the plain version's fp32 autograd.
TOL_SSD = 1e-2


def _ssd_inputs(cuda, b, s, h, p, n, seed=0):
    """x, B and C split from one bf16 row a position, as the Granite mixer
    leaves them; dt after a softplus; A = -exp of normals."""
    g = torch.Generator(device=cuda).manual_seed(seed)
    xbc = torch.randn((b, s, h * p + 2 * n), generator=g, device=cuda,
                      dtype=BF16)
    x = xbc[..., :h * p].unflatten(-1, (h, p))
    B, C = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    dt = torch.nn.functional.softplus(
        torch.randn((b, s, h), generator=g, device=cuda) - 1.0)
    A = -torch.exp(torch.randn(h, generator=g, device=cuda))
    return x, dt, A, B, C


@pytest.mark.cuda
@pytest.mark.parametrize("b,s,h,p,n,chunk", [
    (2, 1000, 8, 64, 128, 256),   # granite's widths: 4 chunks, the last ragged
    (1, 256, 2, 64, 128, 256),    # one whole chunk
    (2, 150, 3, 32, 16, 64),      # the small instantiation, ragged
])
def test_cuda_ssd_kernels_match_plain(cuda, b, s, h, p, n, chunk):
    """y and the gradients of x, dt, A, B and C through ``ssd`` (the
    kernels) against the plain version's fp32 autograd on the same
    inputs, each in its input's type, within TOL_SSD."""
    from ray_tpu_torch.ops import ssd

    ins = [t.detach().requires_grad_()
           for t in _ssd_inputs(cuda, b, s, h, p, n)]
    ssd.reset_counts()
    y = ssd.ssd(*ins, chunk=chunk)
    dy = torch.randn(y.shape, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(3))
    grads = torch.autograd.grad(y, ins, dy)
    refs = [t.detach().float().requires_grad_() for t in ins]
    want = ssd.ssd_reference(*refs, chunk=chunk)
    torch.cuda.synchronize()
    assert y.dtype == torch.float32 and y.shape == want.shape
    assert (y - want).abs().max() <= TOL_SSD * want.abs().max()
    for name, got, ref, t in zip(("x", "dt", "A", "B", "C"), grads,
                                 torch.autograd.grad(want, refs, dy), ins):
        assert got.dtype == t.dtype and got.shape == t.shape, name
        err = (got.float() - ref).abs().max() / ref.abs().max()
        assert err <= TOL_SSD, (name, err.item())
    # The backward makes the entering states again: chunk_state and
    # state_pass twice in it.
    assert ssd.counts() == {"chunk_state": 3, "state_pass": 3,
                            "chunk_scan": 2, "chunk_dg": 1, "chunk_bc": 2}


@pytest.mark.cuda
def test_cuda_ssd_backward_is_deterministic(cuda):
    """The backward's sums over heads and chunks are taken in a fixed
    order (no atomics): two backward calls give the same bits."""
    from ray_tpu_torch.ops import ssd

    x, dt, A, B, C = _ssd_inputs(cuda, 2, 1000, 8, 64, 128, seed=1)
    y = ssd.ssd_kernel_forward(x, dt, A, B, C, 256)[0]
    dy = torch.randn(y.shape, device=cuda,
                     generator=torch.Generator(device=cuda).manual_seed(4))
    first = ssd.ssd_kernel_backward(dy, x, dt, A, B, C, 256)
    second = ssd.ssd_kernel_backward(dy, x, dt, A, B, C, 256)
    torch.cuda.synchronize()
    for name, a, b in zip(("dx", "ddt", "dA", "dB", "dC"), first, second):
        assert torch.equal(a, b), name


@pytest.mark.cuda
def test_cuda_ssd_keeps_nothing_chunk_by_chunk_per_head(cuda):
    """Every tensor the kernel path makes, forward and backward (each op's
    outputs, seen by a dispatch mode), is smaller than one [chunk, chunk]
    block a head: the only chunk x chunk tensor is the gradient of C B^T,
    one block a (batch row, chunk), summed over the heads."""
    from torch.utils._python_dispatch import TorchDispatchMode

    from ray_tpu_torch.ops import ssd

    b, s, h, p, n, q = 2, 1000, 8, 64, 128, 256
    c = -(-s // q)
    shapes = []

    class Record(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            for t in (out if isinstance(out, (tuple, list)) else (out,)):
                if isinstance(t, torch.Tensor):
                    shapes.append(tuple(t.shape))
            return out

    ins = [t.detach().requires_grad_()
           for t in _ssd_inputs(cuda, b, s, h, p, n)]
    with Record():
        y = ssd.ssd(*ins, chunk=q)
        torch.autograd.grad(y, ins, torch.ones_like(y))
    torch.cuda.synchronize()
    quadratic = [sh for sh in shapes if len(sh) >= 2 and sh[-2:] == (q, q)]
    assert quadratic and all(torch.Size(sh).numel() == b * c * q * q
                             for sh in quadratic)
    per_head = b * h * c * q * q
    assert all(torch.Size(sh).numel() < per_head for sh in shapes)


@pytest.mark.cuda
def test_cuda_ssd_refuses_what_it_has_no_instantiation_for(cuda):
    """A p, n or chunk the kernels are not built for, fp32 x, or x whose
    heads are not contiguous: ``ssd`` raises before any launch."""
    from ray_tpu_torch.ops import ssd

    ssd.reset_counts()
    for (p, n, chunk) in ((48, 128, 256), (64, 64, 256), (64, 128, 128),
                          (32, 16, 256)):
        x, dt, A, B, C = _ssd_inputs(cuda, 1, 300, 2, p, n)
        with pytest.raises(ValueError, match="built for"):
            ssd.ssd(x, dt, A, B, C, chunk)
    x, dt, A, B, C = _ssd_inputs(cuda, 1, 300, 2, 64, 128)
    with pytest.raises(TypeError):
        ssd.ssd(x.float(), dt, A, B, C, 256)
    with pytest.raises(ValueError, match="contiguous"):
        ssd.ssd(x.transpose(2, 3).contiguous().transpose(2, 3), dt, A, B, C,
                256)
    assert sum(ssd.counts().values()) == 0


@pytest.mark.cuda
def test_cuda_granite_step_takes_the_scan_kernels(cuda):
    """A tiny Granite 4.0-H (bf16, Mamba heads of 64, d_state 128, chunk
    256, S 300) trains a step on the card: each Mamba layer's scan runs
    the kernels forward, in its recompute and backward, and every ssm span
    says so (``impl`` "kernel")."""
    from ray_tpu_torch.models import granite_hybrid as gh
    from ray_tpu_torch.observability import tracing
    from ray_tpu_torch.ops import ssd
    from ray_tpu_torch.train.optim import adafactor
    from ray_tpu_torch.train.step import build_train

    cfg = gh.GraniteHybridConfig(
        vocab_size=512, hidden_size=128, num_hidden_layers=3,
        layer_types=("mamba", "attention", "mamba"), num_attention_heads=2,
        num_key_value_heads=1, mamba_n_heads=4, mamba_d_head=64,
        mamba_d_state=128, mamba_chunk_size=256, num_local_experts=4,
        num_experts_per_tok=2, intermediate_size=64,
        shared_intermediate_size=64, dtype=BF16)
    init, step = build_train(
        lambda g: gh.GraniteHybrid(cfg, g, device="cpu"),
        lambda m, b: m.loss_fn(b), optimizer=adafactor(1e-3))
    state = init(0)
    tokens = torch.randint(0, 512, (2, 301), device=cuda,
                           generator=torch.Generator(device=cuda)
                           .manual_seed(2))
    tracer = tracing.get_tracer()
    was = tracer.enabled
    tracer.clear()
    tracing.enable()
    ssd.reset_counts()
    try:
        *state, met = step(*state, {"tokens": tokens})
        torch.cuda.synchronize()
    finally:
        if not was:
            tracer.disable()
    spans = [sp for sp in tracer.spans() if sp.name.startswith("ssm.")]
    tracer.clear()
    assert torch.isfinite(met["loss"])
    assert ssd.counts() == {"chunk_state": 8, "state_pass": 8,
                            "chunk_scan": 6, "chunk_dg": 2, "chunk_bc": 4}
    assert sorted(sp.name for sp in spans) == ["ssm.backward"] * 2 + [
        "ssm.forward"] * 4
    assert all(sp.attributes["impl"] == "kernel" for sp in spans)
