"""The port's actor-based RLlib pieces (ray_tpu_torch.rllib) against the
JAX package's (ray_tpu.rllib): the numpy copies, the catalog's LSTMs, the
host policy, V-trace, every loss and the PPO updates.

Both sides get the same numpy-seeded inputs, the JAX package's parameters
carried across by ``convert.py``, and the same keys. Draws and the numpy
copies are held bit for bit; float results within the tolerance each test
states (fp32 throughout unless a test says otherwise).
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from ray_tpu.rllib import a2c as ja2c
from ray_tpu.rllib import appo as jappo
from ray_tpu.rllib import catalog as jcat
from ray_tpu.rllib import connectors as jconn
from ray_tpu.rllib import dqn as jdqn
from ray_tpu.rllib import env as jenv
from ray_tpu.rllib import impala as jimpala
from ray_tpu.rllib import ppo as jppo
from ray_tpu.rllib import replay_buffers as jrb
from ray_tpu.rllib import sample_batch as jsb
from ray_tpu.rllib.policy import JaxPolicy
from ray_tpu_torch import device as tdevice
from ray_tpu_torch.models.convert import (ppo_params_from_numpy,
                                          ppo_tree_to_numpy)
from ray_tpu_torch.rllib import a2c as ta2c
from ray_tpu_torch.rllib import appo as tappo
from ray_tpu_torch.rllib import catalog as tcat
from ray_tpu_torch.rllib import connectors as tconn
from ray_tpu_torch.rllib import dqn as tdqn
from ray_tpu_torch.rllib import env as tenv
from ray_tpu_torch.rllib import impala as timpala
from ray_tpu_torch.rllib import ppo as tppo
from ray_tpu_torch.rllib import replay_buffers as trb
from ray_tpu_torch.rllib import sample_batch as tsb
from ray_tpu_torch.rllib.algorithm import to_learner
from ray_tpu_torch.rllib.policy import TorchPolicy
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, ADVANTAGES, DONES,
                                              LOGPS, NEXT_OBS, OBS, REWARDS,
                                              STATE_IN, VALUE_TARGETS,
                                              VF_PREDS)
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
    """The port's key for a JAX key."""
    data = np.asarray(jax.random.key_data(jkey)).astype(np.int64)
    return torch.from_numpy(data[..., 0]), torch.from_numpy(data[..., 1])


def _rel(got, want) -> float:
    """max |got - want| over max |want|."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _jax_net(obs_shape, actions, model, seed=0):
    """A catalog network of the JAX package, its parameters, and them as
    numpy."""
    net = jcat.get_network(obs_shape, actions, model)
    params = net.init(jax.random.PRNGKey(seed))
    return net, params, jax.tree.map(np.asarray, params)


LSTM = {"use_lstm": True, "lstm_cell_size": 16, "fcnet_hiddens": (32,)}


# -- the numpy copies ---------------------------------------------------------

def test_sample_batch_copy_matches_jax():
    """``compute_gae``, ``flatten_time_major`` and
    ``SampleBatch.concat_samples`` of the copy equal the reference's bit
    for bit (the same numpy code), and every column key is the same."""
    rng = np.random.default_rng(0)
    T, N = 12, 3
    cols = {REWARDS: rng.standard_normal((T, N)).astype(np.float32),
            DONES: rng.random((T, N)) < 0.2,
            VF_PREDS: rng.standard_normal((T, N)).astype(np.float32),
            OBS: rng.standard_normal((T, N, 4)).astype(np.float32)}
    last = rng.standard_normal(N).astype(np.float32)
    got = tsb.flatten_time_major(tsb.compute_gae(
        tsb.SampleBatch({k: v.copy() for k, v in cols.items()}), last,
        0.99, 0.95))
    want = jsb.flatten_time_major(jsb.compute_gae(
        jsb.SampleBatch({k: v.copy() for k, v in cols.items()}), last,
        0.99, 0.95))
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    cat = tsb.SampleBatch.concat_samples([got, got.slice(0, 5)])
    np.testing.assert_array_equal(
        cat[ADVANTAGES],
        jsb.SampleBatch.concat_samples([want, want.slice(0, 5)])[ADVANTAGES])
    assert cat.count == T * N + 5
    assert [b.count for b in cat.minibatches(8)] == [8] * ((T * N + 5) // 8)
    for name in ("OBS", "ACTIONS", "REWARDS", "DONES", "STATE_IN",
                 "NEXT_OBS", "LOGPS", "VF_PREDS", "ADVANTAGES",
                 "VALUE_TARGETS"):
        assert getattr(tsb, name) == getattr(jsb, name)


@pytest.mark.parametrize("name", ["FastCartPole", "FastPendulum",
                                  "RepeatPrevObs", "AtariSim"])
def test_env_copy_matches_jax(name):
    """The same seed and actions give the same trajectory, bit for bit
    (observations, rewards, dones), through auto-resets."""
    n = 3
    envs = [mod.make_env(name, n, 7) for mod in (tenv, jenv)]
    obs = [e.vector_reset(seed=7) for e in envs]
    np.testing.assert_array_equal(obs[0], obs[1])
    rng = np.random.default_rng(1)
    steps = 40 if name != "AtariSim" else 12
    for _ in range(steps):
        if name == "FastPendulum":
            act = rng.uniform(-2, 2, (n, 1)).astype(np.float32)
        else:
            act = rng.integers(0, envs[0].num_actions, n)
        outs = [e.vector_step(act) for e in envs]
        for a, b in zip(outs[0][:3], outs[1][:3]):
            np.testing.assert_array_equal(a, b)


def test_replay_buffer_copies_match_jax():
    """Uniform and prioritized replay from the same seeds sample the same
    rows, and prioritized replay the same importance weights, after the
    same priority updates."""
    rng = np.random.default_rng(2)
    rows = {OBS: rng.standard_normal((200, 4)).astype(np.float32),
            ACTIONS: rng.integers(0, 2, 200).astype(np.int32)}
    for make in (lambda m: m.ReplayBuffer(128, seed=3),
                 lambda m: m.PrioritizedReplayBuffer(128, alpha=0.6,
                                                     seed=3)):
        bufs = [make(trb), make(jrb)]
        for b, sb in zip(bufs, (tsb, jsb)):
            b.add(sb.SampleBatch({k: v.copy() for k, v in rows.items()}))
        for _ in range(3):
            if isinstance(bufs[0], trb.PrioritizedReplayBuffer):
                got, want = (b.sample(16, beta=0.4) for b in bufs)
                pr = rng.random(16) + 0.1
                for b, s in zip(bufs, (got, want)):
                    b.update_priorities(s["batch_indexes"], pr)
            else:
                got, want = (b.sample(16) for b in bufs)
            assert set(got) == set(want)
            for k in want:
                np.testing.assert_array_equal(got[k], want[k])


def test_connector_copy_matches_jax():
    """A pipeline from the same spec transforms the same observations and
    rewards alike, and its saved state restores on the other side."""
    spec = {"agent": [("MeanStdObs", None), ("ClipReward", {"limit": 1.0})],
            "action": []}
    pipes = [m.create_connectors_for_policy(
        m.ConnectorContext(obs_shape=(4,), num_actions=2, num_envs=3),
        spec) for m in (tconn, jconn)]
    rng = np.random.default_rng(4)
    for _ in range(5):
        obs = rng.normal(3.0, 2.0, (3, 4)).astype(np.float32)
        rew = rng.normal(0.0, 3.0, 3).astype(np.float32)
        outs = [(p[0](obs.copy()), p[0].transform_reward(rew.copy()))
                for p in pipes]
        for a, b in zip(*outs):
            np.testing.assert_array_equal(a, b)
    state = {"agent": [c.to_state() for c in pipes[1][0].connectors],
             "action": []}
    agent, _ = tconn.restore_connectors_for_policy(
        tconn.ConnectorContext(obs_shape=(4,), num_actions=2, num_envs=3),
        state)
    obs = rng.normal(3.0, 2.0, (3, 4)).astype(np.float32)
    np.testing.assert_array_equal(agent(obs.copy()), pipes[1][0](obs.copy()))


# -- the catalog ---------------------------------------------------------------

def _frames(n, shape, seed=3):
    rng = np.random.default_rng(seed)
    frames = (rng.random((n,) + shape) < 0.1) * rng.integers(
        0, 256, (n,) + shape)
    return frames.astype(np.uint8)


@pytest.mark.parametrize("kind", ["lstm", "conv_lstm"])
def test_recurrent_forward_matches_jax(kind):
    """``forward_lstm`` / ``forward_conv_lstm`` over 6 steps of 4
    sequences from a non-zero state, with episode ends zeroing the state
    after their step (``scan_sequence``): logits, values and the state
    after each step. LSTM (fp32): 1e-5 of each tensor's largest entry;
    conv-LSTM (bf16 trunk, as the JAX package): 2e-2."""
    T, B = 6, 4
    if kind == "lstm":
        obs_shape, actions = (5,), 3
        obs = np.random.default_rng(5).standard_normal(
            (T, B) + obs_shape).astype(np.float32)
    else:
        obs_shape, actions = (36, 36, 4), 6
        obs = _frames(T * B, obs_shape).reshape((T, B) + obs_shape)
    net, params, tree = _jax_net(obs_shape, actions, LSTM, seed=1)
    assert net.kind == kind
    rng = np.random.default_rng(6)
    state0 = rng.standard_normal((2, B, 16)).astype(np.float32) * 0.5
    dones = np.zeros((T, B), bool)
    dones[1, 0] = dones[3, 2] = dones[3, 3] = True
    tnet = tcat.get_network(obs_shape, actions, LSTM)
    assert tnet.kind == kind and tnet.is_recurrent
    tl, tv, tstate = tcat.scan_sequence(
        tnet.apply_state, ppo_params_from_numpy(tree), torch.from_numpy(obs),
        torch.from_numpy(dones), tuple(torch.from_numpy(state0)))
    state = (jnp.asarray(state0[0]), jnp.asarray(state0[1]))
    tol = 1e-5 if kind == "lstm" else 2e-2
    for t in range(T):
        jl, jv, state = net.apply_state(params, jnp.asarray(obs[t]), state)
        state = tuple(s * (1.0 - dones[t][:, None]) for s in state)
        assert _rel(tl[t], jl) < tol and _rel(tv[t], jv) < tol, t
    for a, b in zip(tstate, state):
        assert _rel(a, b) < tol
    zero = tnet.initial_state(3)
    assert all(z.shape == (3, 16) and not z.any() for z in zero)


def test_forget_gate_bias_and_gate_order():
    """The cell adds 1 to the forget gate and splits i, f, g, o: with
    every weight zero and one gate's bias set, the new cell state is
    sigmoid(f + 1) * c + sigmoid(i) * tanh(g), exactly."""
    params = ppo_params_from_numpy(jax.tree.map(
        np.asarray, jcat.init_lstm_policy(jax.random.PRNGKey(0), 2, 2, (),
                                          4)))
    params["lstm_w"] = torch.zeros_like(params["lstm_w"])
    b = torch.tensor([0.3] * 4 + [-0.7] * 4 + [0.9] * 4 + [0.1] * 4)
    params["lstm_b"] = b
    c0 = torch.full((1, 4), 2.0)
    _, _, (h, c) = tcat.forward_lstm(params, torch.zeros(1, 2),
                                     (torch.zeros(1, 4), c0))
    s = torch.sigmoid
    want_c = s(torch.tensor(-0.7 + 1.0)) * 2.0 + s(torch.tensor(0.3)) * \
        torch.tanh(torch.tensor(0.9))
    torch.testing.assert_close(c, torch.full((1, 4), float(want_c)),
                               rtol=0, atol=1e-7)
    torch.testing.assert_close(h, s(torch.tensor(0.1)) * torch.tanh(c),
                               rtol=0, atol=1e-7)


@pytest.mark.parametrize("which", ["lstm", "conv_lstm", "q_net"])
def test_param_bridge_round_trip(which):
    """The LSTM, conv-LSTM and Q-net trees cross ``convert.py`` and come
    back unchanged (conv weights OIHW here); the port's own init has the
    JAX tree's names and shapes."""
    if which == "q_net":
        tree = jax.tree.map(np.asarray, jdqn.init_q_net(
            jax.random.PRNGKey(0), 4, 2, (32, 32)))
        mine = tdqn.init_q_net(torch.Generator().manual_seed(0), 4, 2,
                               (32, 32))
    else:
        shape = (5,) if which == "lstm" else (36, 36, 4)
        _, _, tree = _jax_net(shape, 3, LSTM)
        mine = tcat.get_network(shape, 3, LSTM).init(
            torch.Generator().manual_seed(0))
    params = ppo_params_from_numpy(tree)
    if which == "conv_lstm":
        assert tuple(params["conv0_w"].shape) == (32, 4, 8, 8)
        assert tuple(params["lstm_w"].shape) == (256 + 16, 64)
    back = ppo_tree_to_numpy(params)
    assert set(back) == set(tree)
    for name in tree:
        np.testing.assert_array_equal(back[name], tree[name])
    assert {k: tuple(v.shape) for k, v in ppo_tree_to_numpy(mine).items()} \
        == {k: v.shape for k, v in tree.items()}


# -- the host policy -------------------------------------------------------------

@pytest.mark.parametrize("model", [None, LSTM], ids=["mlp", "lstm"])
def test_policy_compute_actions_matches_jax(model):
    """``TorchPolicy`` with the JAX policy's weights and seed, over 6
    calls of batch 8 (the key split once a call on both sides): actions
    equal, log-probabilities and values within 1e-6; recurrent: a batch-1
    evaluation call in between leaves the batch-8 state alone,
    ``observe_dones`` zeroes finished slots, and the states agree within
    1e-6; deterministic calls take the argmax."""
    obs_shape = (4,)
    jp = JaxPolicy(obs_shape, 3, seed=5, model_config=model)
    tp = TorchPolicy(obs_shape, 3, seed=5, model_config=model, device="cpu")
    tp.set_weights(jp.get_weights())
    rng = np.random.default_rng(8)
    for step in range(6):
        obs = rng.standard_normal((8,) + obs_shape).astype(np.float32)
        got, want = tp.compute_actions(obs), jp.compute_actions(obs)
        np.testing.assert_array_equal(got[0], want[0])
        assert got[0].dtype == np.int32
        for a, b in zip(got[1:], want[1:]):
            np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-6)
        if step == 2:
            one = rng.standard_normal((1,) + obs_shape).astype(np.float32)
            a1, b1 = tp.compute_actions(one), jp.compute_actions(one)
            np.testing.assert_array_equal(a1[0], b1[0])
        if step == 3:
            dones = np.array([1, 0, 0, 1, 0, 0, 0, 0], bool)
            tp.observe_dones(dones)
            jp.observe_dones(dones)
        det = [p.compute_actions(obs, deterministic=True)[0]
               for p in (tp, jp)]
        np.testing.assert_array_equal(det[0], det[1])
    if model is None:
        assert tp.recurrent_state(8) is None
        return
    for b in (8, 1):
        for a, w in zip(tp.recurrent_state(b), jp.recurrent_state(b)):
            np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-6,
                                       atol=1e-6)


# -- V-trace and the losses --------------------------------------------------

def test_vtrace_matches_jax():
    """vs and the policy-gradient advantages over [16, 5] with dones and
    ratios on both sides of the clips: 1e-6 of the largest entry; both
    outputs carry no gradient."""
    rng = np.random.default_rng(9)
    T, B = 16, 5
    args = [rng.standard_normal((T, B)).astype(np.float32) * 0.5 - 1.0,
            rng.standard_normal((T, B)).astype(np.float32) * 0.5 - 1.0,
            rng.standard_normal((T, B)).astype(np.float32),
            rng.random((T, B)) < 0.15,
            rng.standard_normal((T, B)).astype(np.float32) * 3,
            rng.standard_normal(B).astype(np.float32)]
    want = jimpala.vtrace(*(jnp.asarray(a) for a in args), 0.99)
    targs = [torch.from_numpy(a) for a in args]
    targs[1].requires_grad_()
    targs[4].requires_grad_()
    got = timpala.vtrace(*targs, 0.99)
    for g, w in zip(got, want):
        assert not g.requires_grad
        assert _rel(g.numpy(), w) < 1e-6


def _flat_batch(n, actions=2, seed=10):
    rng = np.random.default_rng(seed)
    return {OBS: rng.standard_normal((n, 4)).astype(np.float32),
            ACTIONS: rng.integers(0, actions, n).astype(np.int32),
            LOGPS: (np.log(1.0 / actions)
                    + 0.1 * rng.standard_normal(n)).astype(np.float32),
            ADVANTAGES: rng.standard_normal(n).astype(np.float32) * 3 + 1,
            VALUE_TARGETS: rng.standard_normal(n).astype(np.float32) * 20}


def _time_major_batch(T, B, recurrent, seed=11):
    rng = np.random.default_rng(seed)
    batch = {OBS: rng.standard_normal((T, B, 4)).astype(np.float32),
             ACTIONS: rng.integers(0, 2, (T, B)).astype(np.int32),
             LOGPS: (np.log(0.5) + 0.3 * rng.standard_normal(
                 (T, B))).astype(np.float32),
             REWARDS: rng.standard_normal((T, B)).astype(np.float32),
             DONES: rng.random((T, B)) < 0.15,
             "final_obs": rng.standard_normal((B, 4)).astype(np.float32)}
    if recurrent:
        batch[STATE_IN] = rng.standard_normal((2, B, 16)).astype(
            np.float32) * 0.3
    return batch


def _q_batch(n, weighted, seed=12):
    rng = np.random.default_rng(seed)
    batch = {OBS: rng.standard_normal((n, 4)).astype(np.float32),
             NEXT_OBS: rng.standard_normal((n, 4)).astype(np.float32),
             ACTIONS: rng.integers(0, 2, n).astype(np.int32),
             REWARDS: rng.standard_normal(n).astype(np.float32),
             DONES: rng.random(n) < 0.2}
    if weighted:
        batch["weights"] = rng.random(n).astype(np.float32)
    return batch


def _loss_case(case):
    """(JAX loss of params, the port's loss of params, JAX params as a
    tree, numpy batch) for one loss."""
    model = LSTM if case == "impala_lstm" else None
    if case.startswith("dqn"):
        jparams = jdqn.init_q_net(jax.random.PRNGKey(0), 4, 2, (32, 32))
        target = jax.tree.map(lambda a: a * 0.9, jparams)
        ttarget = ppo_params_from_numpy(jax.tree.map(np.asarray, target))
        batch = _q_batch(32, weighted=case == "dqn_weighted")
        double_q = case != "dqn_weighted"
        return (lambda p, b: jdqn.dqn_loss(p, target, b, 0.97, double_q),
                lambda p, b: tdqn.dqn_loss(p, ttarget, b, 0.97, double_q),
                jparams, batch)
    net, jparams, _ = _jax_net((4,), 2, model, seed=2)
    tnet = tcat.get_network((4,), 2, model)
    if case == "a2c":
        return (lambda p, b: ja2c.a2c_loss(p, b, 0.5, 0.01, net.apply),
                lambda p, b: ta2c.a2c_loss(p, b, 0.5, 0.01, tnet.apply),
                jparams, _flat_batch(64))
    batch = _time_major_batch(8, 4, model is not None)
    if model is None:
        jfwd = lambda p, b: jimpala.forward_feedforward(p, b, net.apply)
        tfwd = lambda p, b: timpala.forward_feedforward(p, b, tnet.apply)
    else:
        jfwd = lambda p, b: jimpala.forward_recurrent(p, b, net.apply_state)
        tfwd = lambda p, b: timpala.forward_recurrent(p, b,
                                                      tnet.apply_state)
    if case == "appo":
        return (lambda p, b: jappo.appo_loss(p, b, 0.99, 0.5, 0.01, 0.2,
                                             forward=jfwd),
                lambda p, b: tappo.appo_loss(p, b, 0.99, 0.5, 0.01, 0.2,
                                             forward=tfwd),
                jparams, batch)
    return (lambda p, b: jimpala.impala_loss(p, b, 0.99, 0.5, 0.01,
                                             forward=jfwd),
            lambda p, b: timpala.impala_loss(p, b, 0.99, 0.5, 0.01,
                                             forward=tfwd),
            jparams, batch)


@pytest.mark.parametrize("case", ["a2c", "impala", "impala_lstm", "appo",
                                  "dqn", "dqn_weighted"])
def test_loss_and_grads_match_jax(case):
    """The loss, its aux terms (DQN: |TD error|) and every gradient: 1e-5
    relative on the loss and each aux, 1e-5 of each gradient's largest
    entry. ``dqn_weighted`` takes importance weights and vanilla DQN's
    target."""
    jloss_fn, tloss_fn, jparams, batch = _loss_case(case)
    (jloss, jaux), jgrads = jax.value_and_grad(jloss_fn, has_aux=True)(
        jparams, {k: jnp.asarray(v) for k, v in batch.items()})
    tparams = to_learner(jax.tree.map(np.asarray, jparams), "cpu")
    tloss, taux = tloss_fn(tparams, {k: torch.from_numpy(v)
                                     for k, v in batch.items()})
    tloss.backward()
    assert abs(tloss.item() - float(jloss)) <= 1e-5 * abs(float(jloss))
    if isinstance(jaux, dict):
        assert set(taux) == set(jaux)
        for name, want in jaux.items():
            assert abs(taux[name].item() - float(want)) <= 1e-5 * max(
                abs(float(want)), 1e-3), name
    else:
        assert _rel(taux.detach().numpy(), jaux) < 1e-5
    grads = ppo_tree_to_numpy({k: v.grad for k, v in tparams.items()})
    for name, want in jgrads.items():
        assert _rel(grads[name], want) < 1e-5, name


# -- the PPO updates -----------------------------------------------------------

@pytest.mark.parametrize("recurrent", [False, True], ids=["flat", "lstm"])
def test_ppo_update_matches_jax(recurrent):
    """``build_ppo_update`` (128 rows, minibatches of 32, 2 epochs: 8
    steps) and ``build_ppo_update_recurrent`` ([8, 8] sequences with
    STATE_IN, minibatches of 2 sequences: 8 steps) under clip + Adam from
    the same parameters and key: every parameter within 1e-4 of its
    leaf's largest entry, the last minibatch's metrics within 1e-4
    relative."""
    cfg = tppo.PPOConfig().training(sgd_minibatch_size=32 if not recurrent
                                    else 16, num_sgd_iter=2)
    jcfg = jppo.PPOConfig().training(sgd_minibatch_size=cfg.sgd_minibatch_size,
                                     num_sgd_iter=2)
    model = LSTM if recurrent else None
    net, jparams, tree = _jax_net((4,), 2, model, seed=3)
    tnet = tcat.get_network((4,), 2, model)
    jopt = optax.chain(optax.clip_by_global_norm(0.5), optax.adam(3e-4))
    topt = toptim.chain(toptim.clip_by_global_norm(0.5), toptim.adam(3e-4))
    if recurrent:
        batch = _time_major_batch(8, 8, True)
        batch.pop(REWARDS), batch.pop("final_obs")
        rng = np.random.default_rng(13)
        batch[ADVANTAGES] = rng.standard_normal((8, 8)).astype(np.float32)
        batch[VALUE_TARGETS] = rng.standard_normal((8, 8)).astype(
            np.float32) * 5
        jupdate = jppo.build_ppo_update_recurrent(jcfg, jopt, net)
        tupdate = tppo.build_ppo_update_recurrent(cfg, topt, tnet)
    else:
        batch = _flat_batch(128)
        jupdate = jppo.build_ppo_update(jcfg, jopt, net.apply)
        tupdate = tppo.build_ppo_update(cfg, topt, tnet.apply)
    jkey = jax.random.PRNGKey(21)
    jp, _, jm = jupdate(jparams, jopt.init(jparams),
                        {k: jnp.asarray(v) for k, v in batch.items()}, jkey)
    tparams = to_learner(tree, "cpu")
    tp, _, tm = tupdate(tparams, topt.init(
        [p.detach() for p in tparams.values()]),
        {k: torch.from_numpy(v) for k, v in batch.items()}, _key(jkey))
    assert set(tm) == set(jm)
    for name, want in jm.items():
        assert abs(tm[name].item() - float(want)) <= 1e-4 * max(
            abs(float(want)), 1e-3), name
    want = jax.tree.map(np.asarray, jp)
    for name, got in ppo_tree_to_numpy(tp).items():
        assert _rel(got, want[name]) < 1e-4, name


# -- entry points -----------------------------------------------------------

def test_entry_points_default_to_cuda():
    """No device given means CUDA: without a card every learner's
    ``build()`` and the host policy raise rather than run on the CPU; and
    remote rollout workers never start without an injected runtime."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; the card tests cover it")
    for cfg in (tppo.PPOConfig(), ta2c.A2CConfig(), timpala.ImpalaConfig(),
                tappo.APPOConfig(), tdqn.DQNConfig()):
        with pytest.raises(RuntimeError, match="CUDA"):
            cfg.build()
    for make in (lambda: TorchPolicy((4,), 2),
                 lambda: tdqn.QPolicy((4,), 2)):
        with pytest.raises(RuntimeError, match="CUDA"):
            make()
    with pytest.raises(ValueError, match="item 8"):
        tppo.PPOConfig().rollouts(num_rollout_workers=2).build(device="cpu")
