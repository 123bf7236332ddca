"""The port's offline RL (ray_tpu_torch.rllib: offline I/O, the off-policy
estimators, MARWIL/BC and CQL) against the JAX package's.

JSON datasets cross between the packages in both directions, column for
column and dtype for dtype. The numpy estimators (IS, WIS) and the
Monte-Carlo returns are held exactly; the fitted-Q model, DM and DR start
from the JAX model's weights; the learners start from the JAX learner's
parameters (``set_state``) and take the same numpy-seeded minibatches
(bit-equal indices) and keys. Float results within the tolerance each
constant states; fp32 products at IEEE fp32 (``full_fp32``) throughout.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.core.runtime
from ray_tpu.rllib import cql as jcql
from ray_tpu.rllib import marwil as jmarwil
from ray_tpu.rllib import offline as joffline
from ray_tpu.rllib import sac as jsac
from ray_tpu.rllib.env import FastCartPole, FastPendulum
from ray_tpu.rllib.sample_batch import SampleBatch as JSampleBatch
from ray_tpu_torch import device as tdevice
from ray_tpu_torch import random as trandom
from ray_tpu_torch.models.convert import rl_tree_from_numpy, rl_tree_to_numpy
from ray_tpu_torch.rllib import BC, MARWIL, CQLConfig
from ray_tpu_torch.rllib import cql as tcql
from ray_tpu_torch.rllib import marwil as tmarwil
from ray_tpu_torch.rllib import offline as toffline
from ray_tpu_torch.rllib.algorithm import batch_to
from ray_tpu_torch.rllib.sample_batch import (ACTIONS, DONES, LOGPS,
                                              NEXT_OBS, OBS, REWARDS,
                                              SampleBatch)

# FittedQModel's first weights: random.normal's error (at most 5.8e-6 of
# a draw's size) over sqrt(fan_in), relative to the largest weight
# (measured: up to 2.7e-7).
TOL_FQE_INIT = 1e-5
# Fitted-Q, DM and DR after 60-125 Adam steps from the same weights,
# relative (measured: up to 1.5e-7).
TOL_FQE = 1e-5
# Losses, gradients and metrics of updates, relative (measured: up to
# 7.6e-7, a CQL critic gradient).
TOL_LOSS = 1e-5
# Parameters after updates: L2 of the difference over the tree's L2
# (measured: up to 2.2e-7, MARWIL after 6 updates; Adam's first steps:
# see the off-policy tests).
TOL_PARAMS = 2e-6


@pytest.fixture(scope="module", autouse=True)
def _two_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def _full_fp32():
    with tdevice.full_fp32():
        yield


@pytest.fixture(autouse=True)
def _no_runtime(monkeypatch):
    """The JAX package's algorithms start their actor runtime when built;
    these never use it."""
    monkeypatch.setattr(ray_tpu.core.runtime, "auto_init", lambda: None)


def _rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-12))


def _tree_rel(got, want) -> float:
    g = np.concatenate([np.ravel(x) for x in jax.tree.leaves(got)])
    w = np.concatenate([np.ravel(x) for x in jax.tree.leaves(want)])
    return float(np.linalg.norm(g.astype(np.float64) - w)
                 / max(np.linalg.norm(w.astype(np.float64)), 1e-30))


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


# -- offline I/O --------------------------------------------------------------


def _columns(rng):
    """Every dtype a logged batch carries, time-major [T, N] included."""
    return {OBS: rng.normal(size=(5, 3, 4)).astype(np.float32),
            ACTIONS: rng.integers(0, 4, (5, 3)).astype(np.int32),
            REWARDS: rng.normal(size=(5, 3)).astype(np.float64),
            DONES: rng.random((5, 3)) < 0.3,
            LOGPS: rng.normal(size=(5, 3)).astype(np.float32),
            "t": np.arange(15, dtype=np.int64).reshape(5, 3)}


@pytest.mark.parametrize("writer_pkg", ["jax", "port"])
def test_json_crosses_between_packages(tmp_path, writer_pkg):
    """Two files (a small ``max_file_size`` rolls them over) written by one
    package's ``JsonWriter``, read by the other's ``JsonReader``: every
    column equal, dtype for dtype, batch by batch and in ``read_all``."""
    rng = np.random.default_rng(0)
    batches = [_columns(rng) for _ in range(3)]
    if writer_pkg == "jax":
        writer, reader = joffline.JsonWriter, toffline.JsonReader
        wrap = JSampleBatch
    else:
        writer, reader = toffline.JsonWriter, joffline.JsonReader
        wrap = SampleBatch
    w = writer(str(tmp_path), max_file_size=600)
    for b in batches:
        w.write(wrap({k: v.copy() for k, v in b.items()}))
    w.close()
    assert len(list(tmp_path.glob("*.jsonl"))) >= 2
    got = list(reader(str(tmp_path)).iter_batches())
    assert len(got) == len(batches)
    for g, b in zip(got, batches):
        assert set(g) == set(b)
        for k, v in b.items():
            assert g[k].dtype == v.dtype, k
            np.testing.assert_array_equal(g[k], v, err_msg=k)
    whole = reader(str(tmp_path)).read_all()
    for k in batches[0]:
        np.testing.assert_array_equal(
            whole[k], np.concatenate([b[k] for b in batches]), err_msg=k)


def test_json_reader_single_file_and_empty(tmp_path):
    """A file path reads as one file; an empty directory raises in both."""
    w = toffline.JsonWriter(str(tmp_path / "d"))
    w.write(SampleBatch(_columns(np.random.default_rng(1))))
    w.close()
    file = next((tmp_path / "d").glob("*.jsonl"))
    for reader in (toffline.JsonReader, joffline.JsonReader):
        np.testing.assert_array_equal(reader(str(file)).read_all()[OBS],
                                      _columns(np.random.default_rng(1))[OBS])
        (tmp_path / "e").mkdir(exist_ok=True)
        with pytest.raises(ValueError):
            reader(str(tmp_path / "e")).read_all()


# -- off-policy estimators (the recipe of tests/test_ope_dm_dr.py) -----------

D, A = 4, 2


def _target_probs(obs):
    obs = np.asarray(obs, np.float64)
    logits = np.stack([-2.0 * obs[:, 0], 2.0 * obs[:, 0]], axis=1)
    e = np.exp(logits - logits.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def _target_logp(obs, actions):
    p = _target_probs(obs)
    return np.log(p[np.arange(len(actions)),
                    np.asarray(actions).astype(np.int64)])


def _logged(rng, n, episode_len=1):
    """Episodes of ``episode_len`` steps, uniform-random behaviour: the
    contextual bandit of tests/test_ope_dm_dr.py at 1."""
    obs = rng.normal(size=(n, D)).astype(np.float32)
    act = rng.integers(0, A, size=n)
    rew = np.where(act == 1, obs[:, 0], -obs[:, 0]).astype(np.float32)
    dones = (np.arange(n) % episode_len) == episode_len - 1
    next_obs = np.roll(obs, -1, axis=0)
    next_obs[dones] = 0.0
    return {OBS: obs, ACTIONS: act.astype(np.int64), REWARDS: rew,
            NEXT_OBS: next_obs, DONES: dones,
            LOGPS: np.full(n, np.log(0.5), np.float32)}


@pytest.mark.parametrize("episode_len", [1, 5])
def test_importance_sampling_equals_jax(episode_len):
    """IS and WIS: the port's numpy copies give JAX's numbers exactly."""
    cols = _logged(np.random.default_rng(2), 500, episode_len)
    for name in ("ImportanceSampling", "WeightedImportanceSampling"):
        want = getattr(joffline, name)(_target_logp, gamma=0.9).estimate(
            JSampleBatch(dict(cols)))
        got = getattr(toffline, name)(_target_logp, gamma=0.9).estimate(
            SampleBatch(dict(cols)))
        assert got == want, name


def _jax_fqe(seed=0, hidden=(16, 16), lr=5e-3):
    return joffline.FittedQModel(D, A, hidden=hidden, lr=lr, seed=seed)


def test_fitted_q_matches_jax():
    """``FittedQModel``: its first weights (random.normal, keys split as
    JAX's) within TOL_FQE_INIT of JAX's; then, from JAX's weights, ``fit``
    (4 backups x 15 steps) gives the final loss and Q-values within
    TOL_FQE; ``get_weights`` is JAX's list of ``{"w", "b"}`` layers."""
    jm = _jax_fqe()
    tm = toffline.FittedQModel(D, A, hidden=(16, 16), lr=5e-3, seed=0,
                               device="cpu")
    want = _np_tree(jm.params)
    got = tm.get_weights()
    assert [sorted(layer) for layer in got] == [["b", "w"]] * 3
    for g, w in zip(got, want):
        assert _rel(g["w"], w["w"]) < TOL_FQE_INIT
        np.testing.assert_array_equal(g["b"], w["b"])
    tm.set_weights(want)
    cols = _logged(np.random.default_rng(3), 400, episode_len=5)
    args = (cols[OBS], cols[ACTIONS], cols[REWARDS], cols[NEXT_OBS],
            cols[DONES], _target_probs(cols[NEXT_OBS]))
    jl = jm.fit(*args, gamma=0.9, backups=4, sgd_per_backup=15)
    tl = tm.fit(*args, gamma=0.9, backups=4, sgd_per_backup=15)
    assert abs(tl - jl) <= TOL_FQE * abs(jl)
    assert _rel(tm.q_values(cols[OBS]), jm.q_values(cols[OBS])) < TOL_FQE
    assert _tree_rel(tm.get_weights(), _np_tree(jm.params)) < TOL_FQE


@pytest.mark.parametrize("cls", ["DirectMethod", "DoublyRobust"])
def test_dm_dr_match_jax(monkeypatch, cls):
    """DM and DR on 5-step episodes (gamma 0.9, 5 backups): the port's
    model starts from the JAX model's weights for the same seed, and the
    estimates come within TOL_FQE; the behaviour value exactly."""

    class Carried(toffline.FittedQModel):
        def __init__(self, obs_dim, num_actions, hidden, lr, seed, device):
            super().__init__(obs_dim, num_actions, hidden, lr, seed, device)
            self.set_weights(_np_tree(joffline.FittedQModel(
                obs_dim, num_actions, hidden=hidden, lr=lr,
                seed=seed).params))

    monkeypatch.setattr(toffline, "FittedQModel", Carried)
    cols = _logged(np.random.default_rng(4), 600, episode_len=5)
    kw = dict(target_probs_fn=_target_probs, num_actions=A, gamma=0.9,
              q_backups=5, q_hidden=(16, 16))
    want = getattr(joffline, cls)(_target_logp, **kw).estimate(
        JSampleBatch(dict(cols)))
    got = getattr(toffline, cls)(_target_logp, device="cpu", **kw).estimate(
        SampleBatch(dict(cols)))
    assert got["v_behavior"] == want["v_behavior"]
    assert abs(got["v_target"] - want["v_target"]) <= TOL_FQE * abs(
        want["v_target"])


# -- MARWIL and BC ------------------------------------------------------------


def test_monte_carlo_returns_exact():
    """``_monte_carlo_returns`` on flat [T] and time-major [T, N] columns:
    the JAX function's numbers, bit for bit."""
    rng = np.random.default_rng(5)
    for shape in ((40,), (40, 6)):
        cols = {REWARDS: rng.normal(size=shape).astype(np.float32),
                DONES: rng.random(shape) < 0.15}
        want = jmarwil._monte_carlo_returns(JSampleBatch(dict(cols)), 0.97)
        got = tmarwil._monte_carlo_returns(SampleBatch(dict(cols)), 0.97)
        assert got.shape == shape and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def cartpole_dataset(tmp_path_factory):
    """Random-action CartPole logged time-major, [32, 8] a batch, by the
    JAX package's writer (the recipe of tests/test_bc_td3.py, random
    actions in place of a trained PPO's)."""
    path = str(tmp_path_factory.mktemp("marwil_data"))
    env = FastCartPole(num_envs=8, seed=0)
    rng = np.random.default_rng(0)
    writer = joffline.JsonWriter(path)
    obs = env.vector_reset()
    for _ in range(4):
        cols = {OBS: [], ACTIONS: [], REWARDS: [], DONES: []}
        for _ in range(32):
            acts = rng.integers(0, 2, 8).astype(np.int32)
            nobs, rews, dones, _ = env.vector_step(acts)
            for k, v in ((OBS, obs), (ACTIONS, acts), (REWARDS, rews),
                         (DONES, dones)):
                cols[k].append(np.asarray(v))
            obs = nobs
        writer.write(JSampleBatch({k: np.stack(v) for k, v in cols.items()}))
    writer.close()
    return path


def _marwil_pair(path, beta, updates=3):
    """(JAX, port) MARWIL at ``beta``; BC (``BCConfig``) at beta 0."""
    def configure(cfg):
        return (cfg.offline_data(path)
                .rollouts(num_envs_per_worker=2)
                .training(beta=beta, train_batch_size=64,
                          num_updates_per_iter=updates))

    jcls, tcls = ((jmarwil.MARWILConfig, tmarwil.MARWILConfig) if beta
                  else (jmarwil.BCConfig, tmarwil.BCConfig))
    jalgo = configure(jcls()).build()
    talgo = configure(tcls()).build(device="cpu")
    talgo.set_state({"params": jalgo.get_state()["params"]})
    return jalgo, talgo


@pytest.mark.parametrize("beta", [1.0, 0.0])
def test_marwil_update_matches_jax(cartpole_dataset, beta):
    """One update (beta 1: MARWIL with the running adv_norm at 1.7; beta 0:
    BC) from the same parameters and minibatch: the total, policy and
    value losses and the new adv_norm within TOL_LOSS, the parameters
    within TOL_PARAMS."""
    jalgo, talgo = _marwil_pair(cartpole_dataset, beta)
    np.testing.assert_array_equal(talgo._data["returns"],
                                  jalgo._data["returns"])
    idx = np.random.default_rng(6).integers(0, len(jalgo._data["returns"]),
                                            64)
    batch = {k: v[idx] for k, v in jalgo._data.items()}
    jp, _, jtotal, jaux = jalgo._update(
        jalgo.params, jalgo.opt_state,
        {k: jnp.asarray(v) for k, v in batch.items()}, jnp.asarray(1.7))
    tp, _, ttotal, taux = talgo._update(
        talgo.params, talgo.opt_state, batch_to(batch, "cpu"),
        torch.tensor(1.7))
    assert _rel(ttotal, jtotal) < TOL_LOSS
    for k in ("policy_loss", "vf_loss", "adv_norm"):
        assert _rel(taux[k], jaux[k]) < TOL_LOSS, k
    assert _tree_rel(talgo.get_state()["params"], _np_tree(jp)) < TOL_PARAMS


@pytest.mark.parametrize("algo", ["marwil", "bc"])
def test_marwil_training_step_matches_jax(cartpole_dataset, algo):
    """Two whole ``train()`` calls of MARWIL (beta 1) and BC: the same
    minibatch indices (numpy, seeded alike), the losses within TOL_LOSS,
    the running adv_norm and the parameters within TOL_PARAMS, the
    worker's weights the learner's."""
    jalgo, talgo = _marwil_pair(cartpole_dataset,
                                1.0 if algo == "marwil" else 0.0)
    assert isinstance(talgo, BC if algo == "bc" else MARWIL)
    for _ in range(2):
        want, got = jalgo.train(), talgo.train()
        for k in ("total_loss", "policy_loss", "vf_loss"):
            assert _rel(got[k], want[k]) < TOL_LOSS, k
        assert got["timesteps_this_iter"] == want["timesteps_this_iter"]
        assert got["timesteps_total"] == want["timesteps_total"]
    assert _rel(talgo._adv_norm, jalgo._adv_norm) < TOL_PARAMS
    params = talgo.get_state()["params"]
    assert _tree_rel(params, _np_tree(jalgo.params)) < TOL_PARAMS
    wk = talgo.workers.local_worker.get_weights()
    for k, v in params.items():
        np.testing.assert_array_equal(wk[k], v)
    jalgo.stop()
    talgo.stop()


def test_bc_config_is_marwil_at_beta_zero(cartpole_dataset):
    algo = tmarwil.BCConfig().offline_data(cartpole_dataset).rollouts(
        num_envs_per_worker=2).build(device="cpu")
    assert isinstance(algo, BC) and algo.config.beta == 0.0
    r = algo.train()
    assert np.isfinite(r["total_loss"])
    assert r["timesteps_this_iter"] == 32 * 256
    ev = algo.evaluate(episodes=2)
    assert ev["episodes"] >= 2 and np.isfinite(ev["episode_reward_mean"])
    algo.stop()


# -- CQL ----------------------------------------------------------------------


@pytest.fixture(scope="module")
def pendulum_dataset(tmp_path_factory):
    """Logged uniform-action Pendulum transitions, by the port's writer
    (the recipe of tests/test_rllib_more_algos.py at 8 envs x 40 steps)."""
    path = str(tmp_path_factory.mktemp("cql_data"))
    env = FastPendulum(num_envs=8, seed=0)
    rng = np.random.default_rng(0)
    writer = toffline.JsonWriter(path)
    obs = env.vector_reset()
    for _ in range(40):
        acts = rng.uniform(-2, 2, size=(8, 1)).astype(np.float32)
        nobs, rews, dones, _ = env.vector_step(acts)
        writer.write(SampleBatch({OBS: obs.copy(), ACTIONS: acts,
                                  REWARDS: rews, NEXT_OBS: nobs.copy(),
                                  DONES: dones}))
        obs = nobs
    writer.close()
    return path


def _cql_pair(path, **training):
    def configure(cfg):
        cfg.policy_hidden = (32, 32)
        return cfg.offline_data(path).training(train_batch_size=32,
                                               **training)

    jalgo = configure(jcql.CQLConfig()).build()
    talgo = configure(CQLConfig()).build(device="cpu")
    talgo.set_state({"params": jalgo.get_state()["params"]})
    return jalgo, talgo


def _cql_static(cfg):
    return (cfg.action_dim, cfg.action_low, cfg.action_high, cfg.gamma,
            cfg.num_penalty_actions, cfg.min_q_weight)


def test_cql_losses_match_jax(pendulum_dataset):
    """``cql_critic_loss`` (TD loss, penalty over 10 uniform, 10 pi(s) and
    10 pi(s') actions a row) and its critic gradients, and
    ``cql_actor_loss`` in the behaviour-cloning and the SAC phase with its
    actor gradients and logp, at the same parameters, batch and key:
    within TOL_LOSS of JAX's (gradients relative to the largest)."""
    jalgo, talgo = _cql_pair(pendulum_dataset)
    static = _cql_static(jalgo.config)
    idx = np.random.default_rng(7).integers(0, jalgo._n, 48)
    batch = {k: v[idx] for k, v in jalgo._data.items()}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = batch_to(batch, "cpu")
    jparams, tparams = jalgo.params, talgo.params
    key_j, key_t = jax.random.PRNGKey(11), trandom.prng_key(11)

    def jcritic(cp):
        return jcql.cql_critic_loss({**jparams, **cp}, jb, key_j, static)

    (jloss, jaux), jgrad = jax.value_and_grad(jcritic, has_aux=True)(
        {"q1": jparams["q1"], "q2": jparams["q2"]})
    tloss, taux = tcql.cql_critic_loss(tparams, tb, key_t, static)
    tgrad = torch.autograd.grad(tloss, [tparams["q1"]["t0_w"],
                                        tparams["q2"]["out_w"]])
    assert _rel(tloss.detach(), jloss) < TOL_LOSS
    for k in jaux:
        assert _rel(taux[k].detach(), jaux[k]) < TOL_LOSS, k
    assert _rel(tgrad[0], jgrad["q1"]["t0_w"]) < TOL_LOSS
    assert _rel(tgrad[1], jgrad["q2"]["out_w"]) < TOL_LOSS
    for bc in (True, False):
        (jl, jlogp), jg = jax.value_and_grad(jcql.cql_actor_loss,
                                             has_aux=True)(
            jparams["actor"], jparams, jb, key_j, jnp.asarray(bc), static)
        tl, tlogp = tcql.cql_actor_loss(tparams["actor"], tparams, tb, key_t,
                                        bc, static)
        tg = torch.autograd.grad(tl, [tparams["actor"]["t0_w"]])[0]
        assert _rel(tl.detach(), jl) < TOL_LOSS, bc
        assert _rel(tlogp.detach(), jlogp) < TOL_LOSS, bc
        assert _rel(tg, jg["t0_w"]) < TOL_LOSS, bc


def test_cql_training_step_matches_jax(pendulum_dataset):
    """A whole ``train()`` of 4 updates with ``bc_iters`` 2, so the actor
    crosses from behaviour cloning to SAC's objective: the same
    minibatches (numpy, seeded alike) and keys, every metric within
    TOL_LOSS, the parameters (actor, critics, targets, log_alpha) within
    TOL_PARAMS; then ``q_values`` and ``compute_single_action``."""
    jalgo, talgo = _cql_pair(pendulum_dataset, num_updates_per_iter=4,
                             bc_iters=2)
    want, got = jalgo.train(), talgo.train()
    assert set(got) == set(want)
    for k, v in want.items():
        if k == "time_this_iter_s":
            continue
        if isinstance(v, float):
            assert _rel(got[k], v) < TOL_LOSS, k
        else:
            assert got[k] == v, k
    gp, wp = talgo.get_state()["params"], _np_tree(jalgo.params)
    for k in wp:
        assert _tree_rel(gp[k], wp[k]) < TOL_PARAMS, k
    obs, acts = jalgo._data[OBS][:64], jalgo._data[ACTIONS][:64]
    assert _rel(talgo.q_values(obs, acts), jalgo.q_values(obs, acts)) \
        < TOL_PARAMS * 10
    a = talgo.compute_single_action(obs[0])
    assert a.shape == (1,) and -2.0 <= float(a[0]) <= 2.0
    assert _rel(a, jalgo.compute_single_action(obs[0])) < TOL_PARAMS * 10


def test_cql_needs_data_and_defaults():
    """``CQLConfig``'s defaults are the JAX package's; without
    ``offline_data`` it raises as there."""
    j, t = jcql.CQLConfig(), CQLConfig()
    for k in ("action_dim", "action_low", "action_high", "lr",
              "train_batch_size", "num_updates_per_iter", "tau",
              "min_q_weight", "num_penalty_actions", "bc_iters",
              "initial_alpha", "target_entropy", "policy_hidden"):
        assert getattr(t, k) == getattr(j, k), k
    with pytest.raises(ValueError, match="offline_data"):
        CQLConfig().build(device="cpu")


def test_sac_parameters_cross_both_ways():
    """The nested SAC tree crosses JAX -> port -> JAX unchanged."""
    tree = _np_tree(jsac.init_sac_params(jax.random.PRNGKey(2), 3, 1,
                                         (16, 16)))
    back = rl_tree_to_numpy(rl_tree_from_numpy(tree))
    assert jax.tree.structure(back) == jax.tree.structure(tree)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(tree)):
        assert a.shape == b.shape
        np.testing.assert_array_equal(a, b)
