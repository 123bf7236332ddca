"""On-device PPO of the port (ray_tpu_torch.rllib, ray_tpu_torch.random)
against the JAX package's (ray_tpu.rllib.ondevice, jax.random).

Both sides get the same parameters (made by the JAX package's init and
carried across by ``convert.py``), the same keys and the same numpy-seeded
inputs. Draws and the Atari-shaped env are held bit for bit; float
results within the tolerance each test states.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import ondevice as jod
from ray_tpu.rllib import policy as jpol
from ray_tpu.rllib.ppo import ppo_loss as jppo_loss
from ray_tpu.rllib.sample_batch import VF_PREDS, SampleBatch, compute_gae
from ray_tpu_torch import device as tdevice
from ray_tpu_torch import random as trandom
from ray_tpu_torch.models.convert import (ppo_params_from_numpy,
                                          ppo_tree_to_numpy)
from ray_tpu_torch.rllib import ondevice as tod
from ray_tpu_torch.rllib import policy as tpol
from ray_tpu_torch.rllib.ppo import ppo_loss as tppo_loss
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, ADVANTAGES, DONES,
                                              LOGPS, OBS, REWARDS,
                                              VALUE_TARGETS)
from ray_tpu_torch.train import optim as toptim


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    """Two intra-op threads: at these sizes more buy little time and crowd
    the test processes running beside this one."""
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


def _key(jkey):
    """The port's key for a JAX key (or a batch of them)."""
    data = np.asarray(jax.random.key_data(jkey)).astype(np.int64)
    return torch.from_numpy(data[..., 0]), torch.from_numpy(data[..., 1])


def _bits_equal(got: torch.Tensor, want) -> None:
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    if want.dtype == np.float32:
        got, want = got.view(np.uint32), want.view(np.uint32)
    np.testing.assert_array_equal(got, want)


# -- draws ------------------------------------------------------------------

SEEDS = [0, 7, 2**31 - 1]


@pytest.mark.parametrize("lo,hi", [(20.0, 60.0), (-0.05, 0.05), (0.0, 1.0)])
def test_uniform_matches_jax(lo, hi):
    """Bit-equal, single and batched keys (the fused multiply-add of
    XLA's CPU code included)."""
    for seed in SEEDS:
        jkey = jax.random.PRNGKey(seed)
        _bits_equal(trandom.uniform(trandom.prng_key(seed), (64, 4), lo, hi),
                    jax.random.uniform(jkey, (64, 4), jnp.float32, lo, hi))
    jkeys = jax.random.split(jax.random.PRNGKey(3), 5)
    want = jax.vmap(lambda k: jax.random.uniform(k, (10, 2), jnp.float32, lo,
                                                 hi))(jkeys)
    _bits_equal(trandom.uniform(_key(jkeys), (10, 2), lo, hi), want)


def test_randint_and_choice_match_jax():
    """Spans of 4, 7, 1003 and 100000 (the last past 2**16, where the
    uint32 multiplier wraps); choice from the Atari env's velocities."""
    for seed in SEEDS:
        jkey = jax.random.PRNGKey(seed)
        key = trandom.prng_key(seed)
        for lo, hi in [(0, 4), (0, 7), (-3, 1000), (0, 100000)]:
            _bits_equal(trandom.randint(key, (300,), lo, hi).int(),
                        jax.random.randint(jkey, (300,), lo, hi))
        vals = [-2.0, -1.0, 1.0, 2.0]
        _bits_equal(trandom.choice(key, torch.tensor(vals), (256, 2)),
                    jax.random.choice(jkey, jnp.asarray(vals), (256, 2)))


@pytest.mark.parametrize("n", [1000, 32768])
def test_permutation_matches_jax(n):
    """One sorting round at n = 1000, two at 32768 (the bench's batch)."""
    for seed in SEEDS:
        _bits_equal(trandom.permutation(trandom.prng_key(seed), n),
                    jax.random.permutation(jax.random.PRNGKey(seed), n))
    jkeys = jax.random.split(jax.random.PRNGKey(1), 4)
    want = np.stack([np.asarray(jax.random.permutation(k, n))
                     for k in jkeys])
    _bits_equal(trandom.permutation(_key(jkeys), n), want)


@pytest.mark.parametrize("n", [3, 128])
def test_split_matches_jax(n):
    for seed in SEEDS:
        keys = trandom.split(trandom.prng_key(seed), n)
        want = np.asarray(jax.random.key_data(
            jax.random.split(jax.random.PRNGKey(seed), n)))
        got = np.stack([keys[0].numpy(), keys[1].numpy()], -1)
        np.testing.assert_array_equal(got, want)
        assert [int(w) for w in trandom.take(keys, 1)] == want[1].tolist()


# -- envs -------------------------------------------------------------------

def _jax_states(state):
    return {k: np.asarray(v) for k, v in state.items()}


def test_atari_sim_matches_jax_bit_for_bit():
    """Reset and 8 steps under a fixed action sequence, two envs one step
    before the episode limit (so the reset path runs): frames, rewards,
    dones and the ball, velocity and paddle states bit-equal."""
    n = 6
    jenv, tenv = jod.jax_atari_sim(n), tod.atari_sim(n, "cpu")
    jkey = jax.random.PRNGKey(11)
    jstate, jobs = jax.jit(jenv.reset)(jkey)
    tstate, tobs = tenv.reset(_key(jkey))
    _bits_equal(tobs, jobs)
    jstate = dict(jstate, t=jstate["t"].at[:2].set(998))
    tstate["t"][:2] = 998
    actions = np.random.default_rng(0).integers(0, 6, (8, n)).astype(np.int32)
    jstep = jax.jit(jenv.step)
    resets = 0
    for t in range(8):
        jkey, sub = jax.random.split(jkey)
        jstate, jobs, jrew, jdone = jstep(jstate, jnp.asarray(actions[t]), sub)
        tstate, tobs, trew, tdone = tenv.step(
            tstate, torch.from_numpy(actions[t]), _key(sub))
        _bits_equal(tobs, jobs)
        _bits_equal(trew, jrew)
        _bits_equal(tdone, jdone)
        for name, v in _jax_states(jstate).items():
            _bits_equal(tstate[name], v)
        resets += int(tdone.sum())
    assert resets == 2


def test_cartpole_matches_jax():
    """60 steps of random actions: states within 1e-6 absolute plus 1e-6
    relative (XLA's CPU code fuses some products and sums that PyTorch
    rounds apart, and the dynamics compound it: ~6e-7 relative by step
    60), dones and step counts equal."""
    n = 16
    jenv, tenv = jod.jax_cartpole(n), tod.cartpole(n, "cpu")
    jkey = jax.random.PRNGKey(5)
    jstate, jobs = jenv.reset(jkey)
    tstate, tobs = tenv.reset(_key(jkey))
    _bits_equal(tobs, jobs)
    actions = np.random.default_rng(1).integers(0, 2, (60, n)).astype(
        np.int32)
    jstep = jax.jit(jenv.step)
    dones = 0
    for t in range(60):
        jkey, sub = jax.random.split(jkey)
        jstate, jobs, _, jdone = jstep(jstate, jnp.asarray(actions[t]), sub)
        tstate, tobs, trew, tdone = tenv.step(
            tstate, torch.from_numpy(actions[t]), _key(sub))
        np.testing.assert_array_equal(tdone.numpy(), np.asarray(jdone))
        np.testing.assert_allclose(tobs.numpy(), np.asarray(jobs), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(tstate["t"].numpy(),
                                      np.asarray(jstate["t"]))
        assert trew.tolist() == [1.0] * n
        dones += int(tdone.sum())
    assert dones > 0  # the reset path ran


def test_registry_and_devices():
    assert set(tod.ENVS) == set(jod.JAX_ENVS)
    env = tod.ENVS["JaxCartPole"](2, "cpu")
    with pytest.raises(ValueError, match="learner"):
        tod.OnDevicePPO(env, device="meta")


def test_entry_points_default_to_cuda():
    """No device given means CUDA: without a card every entry point
    raises rather than running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the card tests cover it")
    for make in (tod.cartpole, tod.atari_sim):
        with pytest.raises(RuntimeError, match="CUDA"):
            make(2)
    with pytest.raises(RuntimeError, match="CUDA"):
        tod.OnDevicePPO(tod.cartpole(2, "cpu"))


# -- networks ---------------------------------------------------------------

def _jax_params(kind, seed=0, obs_shape=None, actions=None):
    if kind == "mlp":
        obs_shape, actions = obs_shape or (4,), actions or 2
    else:
        obs_shape, actions = obs_shape or (84, 84, 4), actions or 6
    net = jpol.make_network(obs_shape, actions, kind)
    params = net.init(jax.random.PRNGKey(seed))
    return net, params, jax.tree.map(np.asarray, params)


def test_param_bridge_round_trip():
    """HWIO conv weights become OIHW and come back unchanged; the port's
    own init has the JAX tree's names and shapes."""
    for kind in ("mlp", "conv"):
        _, _, tree = _jax_params(kind)
        params = ppo_params_from_numpy(tree)
        if kind == "conv":
            assert tuple(params["conv0_w"].shape) == (32, 4, 8, 8)
        back = ppo_tree_to_numpy(params)
        assert set(back) == set(tree)
        for name in tree:
            np.testing.assert_array_equal(back[name], tree[name])
        obs_shape = (4,) if kind == "mlp" else (84, 84, 4)
        mine = tpol.make_network(obs_shape, 2 if kind == "mlp" else 6,
                                 kind).init(torch.Generator().manual_seed(0))
        assert {k: tuple(v.shape) for k, v in
                ppo_tree_to_numpy(mine).items()} == {
                    k: v.shape for k, v in tree.items()}


def test_forward_mlp_matches_jax():
    """fp32 throughout: 1e-5 absolute."""
    net, params, tree = _jax_params("mlp")
    obs = np.random.default_rng(2).standard_normal((32, 4)).astype(
        np.float32)
    jl, jv = net.apply(params, jnp.asarray(obs))
    tl, tv = tpol.make_network((4,), 2, "mlp").apply(
        ppo_params_from_numpy(tree), torch.from_numpy(obs))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


def _frames(n, seed=3):
    """Atari-shaped frames: mostly blank, some bright pixels."""
    rng = np.random.default_rng(seed)
    frames = (rng.random((n, 84, 84, 4)) < 0.05) * rng.integers(
        0, 256, (n, 84, 84, 4))
    return frames.astype(np.uint8)


def test_forward_conv_matches_jax():
    """The bf16 conv trunk: logits and values within 2e-2 of the largest
    JAX entry (two bf16 paths whose conv kernels sum in other orders;
    measured 9e-5 to 3.3e-3 on this CPU over four seeds), and a (c, h, w)
    flatten of the
    conv output, the layout fault, reads above that."""
    net, params, tree = _jax_params("conv", seed=1)
    obs = _frames(8)
    jl, jv = (np.asarray(a) for a in net.apply(params, jnp.asarray(obs)))
    tp = ppo_params_from_numpy(tree)
    tl, tv = tpol.forward_conv(tp, torch.from_numpy(obs))
    rel = lambda a, b: np.abs(a - b).max() / np.abs(b).max()
    assert rel(tl.numpy(), jl) < 2e-2 and rel(tv.numpy(), jv) < 2e-2

    def chw_flatten(params, x):
        h = x.float().div(255.0).to(torch.bfloat16).permute(0, 3, 1, 2)
        for i, (_c, _k, stride) in enumerate(tpol._CONV_SPEC):
            h = torch.nn.functional.conv2d(
                h, params[f"conv{i}_w"].bfloat16(), stride=stride)
            h = torch.relu(h + params[f"conv{i}_b"].bfloat16()[:, None, None])
        h = torch.relu(h.reshape(h.shape[0], -1) @ params["dense_w"].bfloat16()
                       + params["dense_b"].bfloat16()).float()
        return h @ params["pi_w"] + params["pi_b"]

    assert rel(chw_flatten(tp, torch.from_numpy(obs)).numpy(), jl) > 2e-2


@pytest.mark.parametrize("deterministic", [False, True])
def test_sample_actions_matches_jax(deterministic):
    """The sampling head on 64 observations: the JAX draw's actions (or
    the argmax), log-probabilities within 1e-5, values within 1e-5."""
    net, params, tree = _jax_params("mlp", seed=3)
    obs = np.random.default_rng(7).standard_normal((64, 4)).astype(
        np.float32)
    jkey = jax.random.PRNGKey(9)
    ja, jl, jv = jpol.sample_actions(net.apply, params, jnp.asarray(obs),
                                     jkey, deterministic)
    ta, tl, tv = tpol.sample_actions(
        tpol.make_network((4,), 2, "mlp").apply,
        ppo_params_from_numpy(tree), torch.from_numpy(obs), _key(jkey),
        deterministic)
    np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), atol=1e-5)
    np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


def _batch(kind, n, seed=4):
    rng = np.random.default_rng(seed)
    if kind == "mlp":
        obs, actions = rng.standard_normal((n, 4)).astype(np.float32), 2
    else:
        obs, actions = _frames(n, seed), 6
    return {OBS: obs,
            ACTIONS: rng.integers(0, actions, n).astype(np.int32),
            LOGPS: (np.log(1.0 / actions)
                    + 0.1 * rng.standard_normal(n)).astype(np.float32),
            ADVANTAGES: rng.standard_normal(n).astype(np.float32) * 3 + 1,
            VALUE_TARGETS: rng.standard_normal(n).astype(np.float32) * 20}


@pytest.mark.parametrize("kind", ["mlp", "conv"])
def test_ppo_loss_and_grads_match_jax(kind):
    """Total loss, its aux terms and every gradient. MLP (fp32): 1e-5
    relative on each value, 1e-5 of each gradient's largest entry. Conv
    (bf16 trunk): 2e-2, but 1e-1 on the conv biases' gradients, sums
    over every position of bf16 cotangents that the two packages round
    apart (measured on this CPU: weights 3e-3 to 5e-3, conv biases 2.6e-2
    to 7.4e-2, heads under 6e-4; each bf16 path is 9e-2 to 2.1e-1 from
    an fp32 evaluation of the same loss)."""
    net, params, tree = _jax_params(kind, seed=2)
    batch = _batch(kind, 64)
    args = (0.2, 10.0, 0.5, 0.01)
    (jloss, jaux), jgrads = jax.value_and_grad(jppo_loss, has_aux=True)(
        params, {k: jnp.asarray(v) for k, v in batch.items()}, *args,
        net.apply)
    tparams = {k: v.requires_grad_() for k, v in
               ppo_params_from_numpy(tree).items()}
    apply = tpol.forward_mlp if kind == "mlp" else tpol.forward_conv
    tloss, taux = tppo_loss(tparams, {k: torch.from_numpy(v)
                                      for k, v in batch.items()}, *args,
                            apply)
    tloss.backward()
    tol = 1e-5 if kind == "mlp" else 2e-2
    for name, want in dict(jaux, total=jloss).items():
        got = (taux[name] if name != "total" else tloss).item()
        assert abs(got - float(want)) <= tol * max(abs(float(want)), 1e-3), (
            name, got, float(want))
    grads = ppo_tree_to_numpy({k: v.grad for k, v in tparams.items()})
    for name, want in jgrads.items():
        want = np.asarray(want)
        err = np.abs(grads[name] - want).max() / max(np.abs(want).max(),
                                                     1e-12)
        conv_bias = name.startswith("conv") and name.endswith("_b")
        assert err < (1e-1 if conv_bias else tol), (name, err)


def test_clip_adam_matches_optax():
    """Three updates of chain(clip_by_global_norm(0.5), adam(3e-4)), the
    on-device PPO's optimizer, the first clipped, the last not: 1e-6
    relative to each update's largest entry; the in-place state's count
    and moments follow."""
    rng = np.random.default_rng(5)
    shapes = {"a": (7, 3), "b": (3,), "c": (2, 2, 5)}
    params = {k: rng.standard_normal(s).astype(np.float32)
              for k, s in shapes.items()}
    opt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4))
    jstate = opt.init(params)
    topt = toptim.chain(toptim.clip_by_global_norm(0.5), toptim.adam(3e-4))
    tparams = [torch.from_numpy(params[k].copy()) for k in shapes]
    tstate = topt.init(tparams)
    for scale in (5.0, 1.0, 0.01):
        grads = {k: (scale * rng.standard_normal(s)).astype(np.float32)
                 for k, s in shapes.items()}
        jupd, jstate = opt.update(grads, jstate, params)
        params = optax.apply_updates(params, jupd)
        tupd, tstate = topt.update([torch.from_numpy(grads[k])
                                    for k in shapes], tstate, tparams)
        for p, u in zip(tparams, tupd):
            p.add_(u)
        for k, u in zip(shapes, tupd):
            want = np.asarray(jupd[k])
            assert np.abs(u.numpy() - want).max() <= 1e-6 * np.abs(
                want).max(), k
        for k, p in zip(shapes, tparams):
            np.testing.assert_allclose(p.numpy(), np.asarray(params[k]),
                                       rtol=1e-6, atol=1e-7)
    adam_state = tstate[1][0]
    assert int(adam_state["count"]) == 3
    np.testing.assert_allclose(adam_state["nu"][0].numpy(),
                               np.asarray(jstate[1][0].nu["a"]), rtol=1e-6)


def test_gae_matches_jax():
    """``gae`` against the JAX package's ``compute_gae`` on [T, N]
    rollouts with dones: 1e-6 relative to the largest advantage."""
    rng = np.random.default_rng(6)
    T, N = 32, 5
    rewards = rng.standard_normal((T, N)).astype(np.float32)
    dones = rng.random((T, N)) < 0.1
    values = rng.standard_normal((T, N)).astype(np.float32) * 5
    last = rng.standard_normal(N).astype(np.float32)
    want = compute_gae(SampleBatch({REWARDS: rewards, DONES: dones,
                                    VF_PREDS: values}), last, 0.99, 0.95)
    advs, targets = tod.gae(*(torch.from_numpy(a) for a in
                              (rewards, dones, values, last)), 0.99, 0.95)
    scale = np.abs(want[ADVANTAGES]).max()
    assert np.abs(advs.numpy() - want[ADVANTAGES]).max() <= 1e-6 * scale
    assert np.abs(targets.numpy() - want[VALUE_TARGETS]).max() <= 1e-6 * scale


# -- whole iterations -------------------------------------------------------

def _jax_rollout(algo, jenv, net, params, env_state, obs, key):
    """The JAX program's rollout (``OnDevicePPO.rollout``), step by step:
    its actions, observations, rewards and dones."""
    out = {"actions": [], "obs": [], "rewards": [], "dones": []}
    step = jax.jit(jenv.step)
    for step_key in jax.random.split(key, algo.rollout_length):
        k_act, k_env = jax.random.split(step_key)
        logits, _ = net.apply(params, obs)
        actions = jax.random.categorical(k_act, logits, axis=-1)
        out["obs"].append(np.asarray(obs))
        env_state, obs, rewards, dones = step(env_state, actions, k_env)
        out["actions"].append(np.asarray(actions))
        out["rewards"].append(np.asarray(rewards))
        out["dones"].append(np.asarray(dones))
    return {k: np.stack(v) for k, v in out.items()}


def test_iterate_matches_jax_cartpole():
    """One whole iteration on cartpole(8), rollout 16, 2 minibatches, 2
    epochs, from the JAX learner's parameters: the rollout's actions
    equal the JAX program's, the metrics and every parameter within
    1e-4."""
    kw = dict(rollout_length=16, minibatches=2, num_sgd_iter=2, seed=0)
    jalgo = jod.OnDevicePPO(jod.jax_cartpole(8), **kw)
    tree = jax.tree.map(np.asarray, jalgo.params)
    talgo = tod.OnDevicePPO(tod.cartpole(8, "cpu"), params=tree,
                            device="cpu", **kw)
    _, sub = jax.random.split(jalgo._rng)
    k_roll, _ = jax.random.split(sub)
    want = _jax_rollout(talgo, jalgo.env, jalgo.net, jalgo.params,
                        jalgo.env_state, jalgo._obs, k_roll)
    jm = jalgo.train_iteration()
    tm = talgo.train_iteration()
    traj = talgo.trajectory
    np.testing.assert_array_equal(traj[ACTIONS].numpy(), want["actions"])
    np.testing.assert_array_equal(traj[DONES].numpy(), want["dones"])
    np.testing.assert_allclose(traj[OBS].numpy(), want["obs"], atol=1e-6)
    assert set(tm) == set(jm)
    for name, v in jm.items():
        assert abs(tm[name] - v) <= 1e-4 * max(1.0, abs(v)), name
    jparams = jax.tree.map(np.asarray, jalgo.params)
    for name, p in ppo_tree_to_numpy(talgo.params).items():
        np.testing.assert_allclose(p, jparams[name], atol=1e-4)


def test_atari_iteration_replays_through_jax_env():
    """One conv iteration on atari_sim(2) at rollout 4, 2 minibatches, 2
    epochs: the port's frames, rewards and dones equal, bit for bit, the
    JAX env's stepped with the port's own actions and JAX's keys; the
    metrics are finite and the parameters moved."""
    talgo = tod.OnDevicePPO(tod.atari_sim(2, "cpu"), rollout_length=4,
                            minibatches=2, num_sgd_iter=2, device="cpu")
    before = {k: v.detach().clone() for k, v in talgo.params.items()}
    m = talgo.train_iteration()
    assert m["timesteps_this_iter"] == 8
    assert all(np.isfinite(v) for v in m.values())
    assert any(not torch.equal(before[k], v) for k, v in talgo.params.items())
    jenv = jod.jax_atari_sim(2)
    rng = jax.random.PRNGKey(1)
    reset_key, rng = jax.random.split(rng)
    state, obs = jenv.reset(reset_key)
    _, sub = jax.random.split(rng)
    k_roll, _ = jax.random.split(sub)
    traj = talgo.trajectory
    step = jax.jit(jenv.step)
    for t, step_key in enumerate(jax.random.split(k_roll, 4)):
        _bits_equal(traj[OBS][t], obs)
        _, k_env = jax.random.split(step_key)
        state, obs, rewards, dones = step(
            state, jnp.asarray(traj[ACTIONS][t].numpy()), k_env)
        _bits_equal(traj[REWARDS][t], rewards)
        _bits_equal(traj[DONES][t], dones)
    _bits_equal(talgo._obs, obs)


def test_snapshot_restore_repeats_an_iteration():
    """Restoring a snapshot and iterating again gives the same metrics
    and parameters, bit for bit (eager on the CPU)."""
    algo = tod.OnDevicePPO(tod.cartpole(4, "cpu"), rollout_length=8,
                           minibatches=2, num_sgd_iter=1, device="cpu")
    snap = algo.snapshot()
    first = algo.train_iteration()
    after = [p.detach().clone() for p in algo.params.values()]
    algo.restore(snap)
    assert algo.train_iteration() == first
    for a, p in zip(after, algo.params.values()):
        assert torch.equal(a, p)
