"""Granite 4.0-H on the port (``ray_tpu_torch.models.granite_hybrid``, the
chunked scan ``ops/ssd.py``, the dropless experts of ``parallel/moe.py``)
against the plain fp32 reference ``tests/granite_hybrid_reference.py``, on
the CPU at a tiny size: d 64, 4 Mamba heads of 16 (d_inner 64), d_state 8,
chunk 8, S 20 (not a multiple of the chunk), one attention layer of 4
heads over 2 KV heads, 6 experts of width 16 with top-3, 3 of them held.

Both sides compute in fp32 here. Tolerances, each from what differs
between the two sides and nothing else:

- the loss: 2e-6 relative (fp32 sums in other orders: the chunked scan
  against the quadratic form, the loss's chunks, the experts' fp32 sums);
- each gradient: 2e-5 of its own largest entry plus 2e-5 relative (the
  same sums, and the scan's backward by recomputation against autograd
  through the quadratic form);
- the scan alone: 2e-5 of the output's largest entry (the chunks' decays
  are differences of fp32 cumulative sums, the reference's of fp64 ones);
- the experts alone: 1e-5 of the largest entry (fp32 sums in another
  order);
- one Adafactor step: every leaf's update is lr times its block RMS times
  the sign of its gradient (no leaf here reaches 128 in its two largest
  axes, so none is factored), so the parameters after it agree to 1e-6
  of each parameter's largest entry.

The reference file is ``portbench/reference/granite_hybrid.py`` byte for
byte, and is loaded as a module of ``portbench.reference`` so that it takes
the GPT-2 reference's Adafactor from beside it.
"""

import importlib.util
import sys
from pathlib import Path

import pytest
import torch

from ray_tpu_torch import device as tdevice
from ray_tpu_torch.models import granite_hybrid as gh
from ray_tpu_torch.observability import tracing
from ray_tpu_torch.ops import _build
from ray_tpu_torch.ops import ssd as ssd_mod
from ray_tpu_torch.parallel import moe
from ray_tpu_torch.train import optim
from ray_tpu_torch.train.step import build_train

HERE = Path(__file__).resolve().parent
CONF = dict(
    vocab_size=128, hidden_size=64, num_hidden_layers=3,
    layer_types=["mamba", "attention", "mamba"], num_attention_heads=4,
    num_key_value_heads=2, attention_multiplier=0.0625,
    attention_bias=False, position_embedding_type="nope", mamba_n_heads=4,
    mamba_d_head=16, mamba_d_state=8, mamba_n_groups=1, mamba_d_conv=4,
    mamba_expand=1, mamba_chunk_size=8, mamba_conv_bias=True,
    mamba_proj_bias=False, num_local_experts=6, num_experts_per_tok=3,
    intermediate_size=16, shared_intermediate_size=32, hidden_act="silu",
    embedding_multiplier=12.0, residual_multiplier=0.22, logits_scaling=16.0,
    rms_norm_eps=1e-5, router_aux_loss_coef=0.001, initializer_range=0.02,
    tie_word_embeddings=True)
HELD = (0, 3)
B, S = 2, 20
LR = 1e-2


def _reference():
    name = "portbench.reference._granite_hybrid_tests"
    if name not in sys.modules:
        spec = importlib.util.spec_from_file_location(
            name, HERE / "granite_hybrid_reference.py")
        mod = importlib.util.module_from_spec(spec)
        sys.modules[name] = mod
        spec.loader.exec_module(mod)
    return sys.modules[name]


ref = _reference()


@pytest.fixture(autouse=True)
def _full_fp32():
    with tdevice.full_fp32():
        yield


def _model(held=HELD, seed=0):
    """The program's model at the tiny size, its weights from ``seed`` with
    the constants (norms, dt_bias, A_log, D, biases) moved off their
    initial values so that a wrong use of one shows."""
    cfg = gh.GraniteHybridConfig.from_dict(CONF, experts_held=held)
    gen = torch.Generator().manual_seed(seed)
    model = gh.GraniteHybrid(cfg, gen, device="cpu")
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.dim() == 1:
                p.add_(0.3 * torch.randn(p.shape, generator=gen))
        for name, p in model.named_parameters():
            if name.endswith(("experts_in", "experts_out", "router")):
                p.mul_(20.0)  # routing and experts that matter to the loss
    return model


def _tokens(seed=1):
    return torch.randint(0, CONF["vocab_size"], (B, S + 1),
                         generator=torch.Generator().manual_seed(seed))


def _close(a, b, rel, name=""):
    scale = b.abs().max().item()
    err = (a - b).abs().max().item()
    assert err <= rel * scale + 1e-30, (name, err, scale)


def test_reference_copies_are_identical():
    assert (HERE / "granite_hybrid_reference.py").read_bytes() == (
        HERE.parent / "portbench" / "reference" /
        "granite_hybrid.py").read_bytes()


def test_parameter_names_and_shapes():
    model = _model()
    names = [nm for nm, _ in model.named_parameters()]
    assert "layers.1.attn.wq" in names and "layers.0.mamba.A_log" in names
    assert model.layers[0].moe.experts_in.shape == (3, 64, 32)
    assert model.layers[0].moe.router.shape == (64, 6)
    # Each parameter an optimizer leaf of its own.
    assert all(not leaf.stacked for leaf in optim.leaf_groups(names))


@pytest.mark.parametrize("s", [S, 16])  # a part chunk last; whole chunks
def test_loss_and_grads_match_reference(s):
    """Each layer recomputed in the backward; without gradients the same
    layers run once, to the same loss."""
    model = _model()
    tokens = _tokens()[:, :s + 1]
    loss = model.loss_fn({"tokens": tokens})
    loss.backward()
    with torch.no_grad():
        assert model.loss_fn({"tokens": tokens}).item() == loss.item()
    params = {n: p.detach().clone().requires_grad_()
              for n, p in model.named_parameters()}
    want = ref.loss(params, tokens, CONF, HELD)
    grads = torch.autograd.grad(want, list(params.values()))
    assert abs(loss.item() - want.item()) <= 2e-6 * abs(want.item())
    for (name, p), g in zip(model.named_parameters(), grads):
        assert p.grad is not None, name
        err = (p.grad - g).abs()
        assert (err <= 2e-5 * g.abs().max() + 2e-5 * g.abs()).all(), (
            name, err.max().item(), g.abs().max().item())


def test_one_adafactor_step_matches_reference():
    model = _model()
    tokens = _tokens()
    params0 = {n: p.detach().clone() for n, p in model.named_parameters()}
    init, step = build_train(lambda _g: model, lambda m, b: m.loss_fn(b),
                             optim.adafactor(LR), device="cpu")
    state = init(0)
    *state, met = step(*state, {"tokens": tokens})
    cur = {n: t.clone().requires_grad_() for n, t in params0.items()}
    value = ref.loss(cur, tokens, CONF, HELD)
    grads = dict(zip(cur, torch.autograd.grad(value, list(cur.values()))))
    upd = ref.Adafactor(LR).updates(cur, grads)
    assert abs(met["loss"].item() - value.item()) <= 2e-6 * value.item()
    for name, p in state[0].named_parameters():
        want = params0[name] + upd[name]
        _close(p.detach(), want, 1e-6, name)
        assert not torch.equal(p.detach(), params0[name]), name


def _scan_inputs(s, heads=4, p=16, n=8, seed=0):
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(B, s, heads, p, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(B, s, heads, generator=g))
    A = -torch.exp(torch.randn(heads, generator=g))
    Bm = torch.randn(B, s, n, generator=g)
    C = torch.randn(B, s, n, generator=g)
    return [t.requires_grad_() for t in (x, dt, A, Bm, C)]


@pytest.mark.parametrize("s,chunk,block_bytes", [
    (8, 8, ssd_mod.BLOCK_BYTES),     # one chunk
    (20, 8, ssd_mod.BLOCK_BYTES),    # three, the last ragged
    (20, 8, 1),                      # the same, one head a block
    (32, 8, ssd_mod.BLOCK_BYTES),    # four whole chunks
])
def test_chunked_scan_matches_quadratic_form(monkeypatch, s, chunk,
                                             block_bytes):
    monkeypatch.setattr(ssd_mod, "BLOCK_BYTES", block_bytes)
    ins = _scan_inputs(s)
    y = ssd_mod.ssd(*ins, chunk=chunk)
    want = ref.ssd_quadratic(*ins)
    _close(y, want, 2e-5, "y")
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(3))
    got = torch.autograd.grad(y, ins, dy)
    exp = torch.autograd.grad(want, ins, dy)
    for name, a, b in zip(("x", "dt", "A", "B", "C"), got, exp):
        _close(a, b, 2e-5, name)


def test_dropless_with_every_token_on_one_expert():
    """Expert 1 is every token's first choice: all B*S tokens reach it (a
    capacity of 1.25 * T * k / E would keep 0.625 T of them), and the layer
    equals the reference's."""
    model = _model()
    layer = model.layers[0].moe
    with torch.no_grad():
        layer.router[:, 1] = 0.0
        layer.router[0, 1] = 50.0
    h = torch.randn(B * S, 64, generator=torch.Generator().manual_seed(5))
    h[:, 0] = h[:, 0].abs() + 1.0
    routed, probs, counts = moe.moe_dropless(
        h, layer.router, layer.experts_in, layer.experts_out, num_experts=6,
        top_k=3, experts_held=HELD)
    assert counts[1].item() == B * S
    assert moe.capacity_for(B * S, 6, 3, 1.25) < B * S
    w = {f"moe.{n}": p.detach() for n, p in layer.named_parameters()}
    want, _ = ref.experts(h, w, CONF, HELD, "fp32")
    shared = ref._swiglu(h, w["moe.shared_in"], w["moe.shared_out"], "fp32")
    _close(routed, want - shared, 1e-5)


def test_expert_shares_add_up_to_the_uncut_layer():
    """Expert parallelism's shares tie to the model: the routed parts of
    shares (0, 3) and (3, 3), plus the shared expert once, are the uncut
    layer's output."""
    whole = _model(held=(0, 6))
    halves = [_model(held=share) for share in ((0, 3), (3, 3))]
    with torch.no_grad():
        for half, first in zip(halves, (0, 3)):
            for hp, wp in zip(half.named_parameters(),
                              whole.named_parameters()):
                if hp[0].endswith(("experts_in", "experts_out")):
                    hp[1].copy_(wp[1][first:first + 3])
                else:
                    hp[1].copy_(wp[1])
    h = torch.randn(B, S, 64, generator=torch.Generator().manual_seed(6))
    outs = [m.layers[0].moe(h)[0] for m in halves]
    moe_w = whole.layers[0].moe
    shared = (torch.nn.functional.silu(h @ moe_w.shared_in[:, :32])
              * (h @ moe_w.shared_in[:, 32:])) @ moe_w.shared_out
    w = {f"moe.{n}": p.detach() for n, p in moe_w.named_parameters()}
    want, _ = ref.experts(h.reshape(-1, 64), w, CONF, (0, 6), "fp32")
    _close(outs[0] + outs[1] - shared, want.view_as(h), 1e-5)
    _close(whole.layers[0].moe(h)[0], want.view_as(h), 1e-5)


def test_spans_of_a_step_join_its_trace():
    """Under the tracer, one step's trace holds each layer, scan and expert
    layer's forward twice (the forward and the layer's recompute in the
    backward) and its backward once; the scans and experts nest under
    their layer; ``moe.forward`` counts the pairs."""
    model = _model()
    init, step = build_train(lambda _g: model, lambda m, b: m.loss_fn(b),
                             optim.adafactor(LR), device="cpu")
    state = init(0)
    tracer = tracing.get_tracer()
    was = tracer.enabled
    tracer.clear()
    tracing.enable()
    try:
        step(*state, {"tokens": _tokens()})
    finally:
        if not was:
            tracer.disable()
    spans = tracer.spans()
    root = [s for s in spans if s.name == "train.step"][-1]
    mine = [s for s in spans if s.trace_id == root.trace_id]
    count = lambda n: sum(s.name == n for s in mine)  # noqa: E731
    assert (count("ssm.forward"), count("ssm.backward")) == (4, 2)
    assert (count("moe.forward"), count("moe.backward")) == (6, 3)
    assert count("granite.layer") == 6
    layers = {s.span_id for s in mine if s.name == "granite.layer"}
    assert all(s.parent_id in layers for s in mine
               if s.name in ("ssm.forward", "moe.forward", "attn.forward"))
    fwd = [s for s in mine if s.name == "moe.forward"]
    assert all(0 < s.attributes["pairs_held"] <= B * S * 3 for s in fwd)
    assert all(s.attributes["max_expert_pairs"] <= s.attributes["pairs_held"]
               for s in fwd)
    scan = [s for s in mine if s.name == "ssm.forward"][0]
    assert scan.attributes["shape"] == (B, S, 4, 16, 8)
    assert scan.attributes["chunk"] == 8
    tracer.clear()


def test_expand_kv_heads_refuses_heads_it_does_not_hold():
    from ray_tpu_torch.models.common import expand_kv_heads

    k = torch.arange(3.0).view(1, 3, 1, 1)
    ek, _ = expand_kv_heads(k, k, 6, 2)
    assert ek.flatten().tolist() == [0, 0, 1, 1, 2, 2]
    with pytest.raises(ValueError, match="does not hold"):
        expand_kv_heads(k[:, :1], k[:, :1], 4, 2, q0=0, k0=0)


def test_cpu_scans_take_the_plain_path_and_say_so():
    """CPU tensors take the plain scan: a traced step's ``ssm.*`` spans all
    say ``impl`` "plain" and no kernel is launched."""
    model = _model()
    init, step = build_train(lambda _g: model, lambda m, b: m.loss_fn(b),
                             optim.adafactor(LR), device="cpu")
    state = init(0)
    tracer = tracing.get_tracer()
    was = tracer.enabled
    tracer.clear()
    tracing.enable()
    _build.reset_launch_counts()
    try:
        step(*state, {"tokens": _tokens()})
    finally:
        if not was:
            tracer.disable()
    scans = [s for s in tracer.spans() if s.name.startswith("ssm.")]
    tracer.clear()
    assert len(scans) == 6
    assert all(s.attributes["impl"] == "plain" for s in scans)
    assert _build.launch_counts() == {}


def test_cpu_norms_take_the_plain_versions_and_are_counted():
    """CPU tensors take both RMSNorm forms' plain versions, and a traced
    step counts each call on ``train.step``: the input and post norms of
    every layer and the gated norm of every Mamba layer, each in the
    forward and the recompute, and the final norm."""
    model = _model()
    init, step = build_train(lambda _g: model, lambda m, b: m.loss_fn(b),
                             optim.adafactor(LR), device="cpu")
    state = init(0)
    tracer = tracing.get_tracer()
    was = tracer.enabled
    tracer.clear()
    tracing.enable()
    _build.reset_launch_counts()
    try:
        step(*state, {"tokens": _tokens()})
    finally:
        if not was:
            tracer.disable()
    root = [s for s in tracer.spans() if s.name == "train.step"][-1]
    tracer.clear()
    layers = len(CONF["layer_types"])
    mamba = CONF["layer_types"].count("mamba")
    assert root.attributes["rms_norm_plain_calls"] == \
        2 * 2 * layers + 1 + 2 * mamba
    assert root.attributes["rms_norm_kernel_calls"] == 0
    assert _build.launch_counts() == {}


def _kernel_inputs(b=2, s=300, h=2, p=64, n=128):
    """The mixer's layout: x, B and C split from one bf16 row a position."""
    xbc = torch.zeros(b, s, h * p + 2 * n, dtype=torch.bfloat16)
    x = xbc[..., :h * p].unflatten(-1, (h, p))
    B, C = xbc[..., h * p:h * p + n], xbc[..., h * p + n:]
    return dict(x=x, dt=torch.ones(b, s, h), A=-torch.ones(h), B=B, C=C)


def test_kernel_checks_take_the_mixers_layout():
    for p, n, chunk in ssd_mod.KERNEL_SHAPES:
        ins = _kernel_inputs(p=p, n=n)
        ssd_mod.check_kernel_layout(**ins, chunk=chunk)
    with pytest.raises(ValueError, match="CUDA"):
        ssd_mod.check_kernel_inputs(**_kernel_inputs(), chunk=256)


def _bad(name):
    ins = _kernel_inputs()
    if name == "x fp32":
        ins["x"] = ins["x"].float()
    elif name == "dt bf16":
        ins["dt"] = ins["dt"].bfloat16()
    elif name == "B fp32":
        ins["B"] = ins["B"].float()
    elif name == "dt shape":
        ins["dt"] = ins["dt"][:, :-1]
    elif name == "A shape":
        ins["A"] = -torch.ones(3)
    elif name == "C shape":
        ins["C"] = ins["C"][:, :-1]
    elif name == "p 48":
        ins["x"] = ins["x"][..., :48]
    elif name == "heads strided":
        ins["x"] = ins["x"].transpose(2, 3).contiguous().transpose(2, 3)
    elif name == "B, C strides differ":
        ins["C"] = ins["C"].contiguous()
    elif name == "position stride":
        ins["x"] = torch.zeros(2, 300, 2 * 64 + 4,
                               dtype=torch.bfloat16)[..., :128].unflatten(
                                   -1, (2, 64))
    elif name == "misaligned":
        base = torch.zeros(2 * 300 * 384 + 8, dtype=torch.bfloat16)
        ins["B"] = base[4:4 + 2 * 300 * 384].view(2, 300, 384)[..., :128]
        ins["C"] = base[4:4 + 2 * 300 * 384].view(2, 300, 384)[..., 128:256]
    return ins


@pytest.mark.parametrize("name,chunk,error", [
    ("x fp32", 256, TypeError), ("dt bf16", 256, TypeError),
    ("B fp32", 256, TypeError), ("dt shape", 256, ValueError),
    ("A shape", 256, ValueError), ("C shape", 256, ValueError),
    ("p 48", 256, ValueError), ("chunk 128", 128, ValueError),
    ("heads strided", 256, ValueError),
    ("B, C strides differ", 256, ValueError),
    ("position stride", 256, ValueError), ("misaligned", 256, ValueError),
])
def test_kernel_checks_refuse_before_any_launch(monkeypatch, name, chunk,
                                                error):
    """What the kernels do not take raises in the wrapper's checks; the
    launch is never reached."""
    def launch(*args, **kwargs):
        raise AssertionError("launched")

    monkeypatch.setattr(_build, "launch", launch)
    with pytest.raises(error):
        ssd_mod.check_kernel_layout(**_bad(name), chunk=chunk)
