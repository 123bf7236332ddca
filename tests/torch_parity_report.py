"""Prints the CPU parity errors of the PyTorch port against the JAX
package, module by module, at the sizes of the ``tests/test_torch_*.py``
tests (which assert the bounds; this prints the measured values).

    JAX_PLATFORMS=cpu python tests/torch_parity_report.py

All in fp32 on the CPU. Errors are max |port - jax|, and for gradients
and parameters also over the largest |jax| entry of the tensor.
"""

import os
import sys

os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from ray_tpu.models import gpt2 as jgpt2  # noqa: E402
from ray_tpu.ops import attention as jattn  # noqa: E402
from ray_tpu.parallel.mesh import MeshSpec  # noqa: E402
from ray_tpu.train.optim import adamw_lowmem as j_adamw  # noqa: E402
from ray_tpu.train.step import build_sharded_train  # noqa: E402
from ray_tpu_torch.models import gpt2 as tgpt2  # noqa: E402
from ray_tpu_torch.models.convert import (  # noqa: E402
    gpt2_params_from_numpy, gpt2_tree_to_numpy)
from ray_tpu_torch.ops import attention as tattn  # noqa: E402
from ray_tpu_torch.train.optim import adamw_lowmem as t_adamw  # noqa: E402
from ray_tpu_torch.train.step import build_train  # noqa: E402

TINY = dict(vocab_size=128, max_seq=64, num_layers=2, num_heads=2,
            d_model=64)


def err(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    d = float(np.abs(a - b).max())
    return d, d / max(float(np.abs(b).max()), 1e-30)


def attention_report():
    rng = np.random.default_rng(0)
    for causal in (True, False):
        q, k, v, do = (rng.standard_normal((2, 2, 128, 64)).astype(
            np.float32) for _ in range(4))
        jq, jk, jv = map(jnp.asarray, (q, k, v))
        o, lse = jattn._flash_fwd_pallas(jq, jk, jv, causal, 0.125, 64, 64,
                                         interpret=True)
        grads = jax.grad(lambda a, b, c: jnp.sum(jattn.flash_attention(
            a, b, c, causal=causal, block_q=64, block_k=64) * do),
            argnums=(0, 1, 2))(jq, jk, jv)
        ts = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
        to = tattn.flash_attention(*ts, causal=causal)
        (to * torch.from_numpy(do)).sum().backward()
        tlse = tattn.flash_fwd(*(t.detach() for t in ts), causal, 0.125)[1]
        parts = [("o", to.detach(), o), ("lse", tlse, lse)] + [
            (n, t.grad, g) for n, t, g in zip(("dq", "dk", "dv"), ts, grads)]
        print(f"ops/attention [2,2,128,64] causal={causal}: " + ", ".join(
            f"{n} {err(a, b)[0]:.2e}" for n, a, b in parts))


def gpt2_report():
    jcfg = jgpt2.GPT2Config(**TINY, dtype=jnp.float32,
                            attention_impl="flash")
    tcfg = tgpt2.GPT2Config(**TINY, dtype=torch.float32)
    params, _ = jgpt2.init_params(jax.random.PRNGKey(0), jcfg)
    model = tgpt2.GPT2(tcfg)
    model.load_state_dict(gpt2_params_from_numpy(
        jax.tree.map(np.asarray, params), tcfg))
    tokens = np.random.default_rng(0).integers(0, 128, (2, 33)).astype(
        np.int32)
    lj, gj = jax.value_and_grad(lambda p: jgpt2.loss_fn(
        p, {"tokens": jnp.asarray(tokens)}, jcfg))(params)
    lt = model.loss_fn({"tokens": torch.from_numpy(tokens)})
    lt.backward()
    gt = gpt2_tree_to_numpy({n: p.grad for n, p in
                             model.named_parameters()}, tcfg)
    worst = max(err(a, b)[1] for a, b in zip(jax.tree.leaves(gt),
                                             jax.tree.leaves(gj)))
    print(f"models/gpt2 (2 layers, d64, S32): loss |diff| "
          f"{err(lt.detach(), lj)[0]:.2e}; worst gradient rel {worst:.2e}")


def train_report():
    jcfg = jgpt2.GPT2Config(**TINY, dtype=jnp.float32,
                            attention_impl="flash")
    tcfg = tgpt2.GPT2Config(**TINY, dtype=torch.float32)
    init_tree = jax.tree.map(np.asarray, jgpt2.init_params(
        jax.random.PRNGKey(0), jcfg)[0])

    def init_fn(_):
        m = tgpt2.GPT2(tcfg)
        m.load_state_dict(gpt2_params_from_numpy(init_tree, tcfg))
        return m

    for master in (False, True):
        sinit, sstep, _ = build_sharded_train(
            lambda key: jgpt2.init_params(key, jcfg),
            lambda p, b: jgpt2.loss_fn(p, b, jcfg),
            MeshSpec(dp=1).build(jax.devices()[:1]),
            optimizer=j_adamw(1e-3, eps=1e-5), master_fp32=master)
        jp, jo, js = sinit(jax.random.PRNGKey(0))
        tinit, tstep = build_train(init_fn, lambda m, b: m.loss_fn(b),
                                   optimizer=t_adamw(1e-3, eps=1e-5),
                                   master_fp32=master, device="cpu")
        model, to, ts = tinit(0)
        rng = np.random.default_rng(0)
        for i in range(3):
            tok = rng.integers(0, 128, (2, 33)).astype(np.int32)
            jp, jo, js, jm = sstep(jp, jo, js, {"tokens": jnp.asarray(tok)})
            model, to, ts, tm = tstep(model, to, ts,
                                      {"tokens": torch.from_numpy(tok)})
            tp = gpt2_tree_to_numpy(dict(model.named_parameters()), tcfg)
            worst = max(err(a, b)[1] for a, b in zip(
                jax.tree.leaves(tp), jax.tree.leaves(jp)))
            print(f"train/step master_fp32={master} step {i}: loss |diff| "
                  f"{err(tm['loss'], jm['loss'])[0]:.2e}, grad_norm rel "
                  f"{err(tm['grad_norm'], jm['grad_norm'])[1]:.2e}, worst "
                  f"parameter rel {worst:.2e}")


if __name__ == "__main__":
    jax.config.update("jax_platforms", "cpu")
    attention_report()
    gpt2_report()
    train_report()
