"""The port's Train library (``ray_tpu_torch.train``) on the JAX package's
actor runtime, injected as ``runtime=ray_tpu.core`` (the port imports no
runtime itself), against ``ray_tpu.train``.

- The cases of ``tests/test_train.py``, each run through both packages
  with the same numpy-only train loop (it imports the ``session`` of the
  package it runs in): their results (metrics, history, kept checkpoints,
  errors) must be equal.
- A tiny GPT-2 through ``JaxTrainer`` and ``TorchTrainer``, the port from
  the JAX initial parameters: losses within 1e-5 relative (the tolerance
  of ``tests/test_torch_train_step.py``; both run in fp32).
- Checkpoints across the packages, bit for bit; an orbax directory and a
  bf16 ``ml_dtypes`` tree make the port raise.
- Two ``WorkerGroup`` processes forming one gloo world through the
  port's ``Bootstrap`` on the native control store: one
  ``build_sharded_train`` step at ``MeshSpec(dp=2)`` gives one process's
  loss on the whole batch.
- ``HostGroup``: the two cases of ``tests/test_collective_p2p.py``.

Every train loop and actor body is defined inside its test, so that it is
pickled by value and the workers need not import this module.
"""

import importlib
import os
import pickle

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import ray_tpu.core
from ray_tpu.models import gpt2 as jgpt2
from ray_tpu_torch import device as tdevice
from ray_tpu_torch.models import gpt2 as tgpt2
from ray_tpu_torch.train import Checkpoint, restore_arrays
from ray_tpu_torch.train.step import build_train
from torch_time_limit import time_limit

LIMIT_S = 240  # each test's own limit (torch_time_limit)
LIBS = {"jax": "ray_tpu.train", "torch": "ray_tpu_torch.train"}


_limit = time_limit(LIMIT_S)


def _lib(pkg):
    return importlib.import_module(LIBS[pkg])


def _rt(pkg):
    return {"runtime": ray_tpu.core} if pkg == "torch" else {}


def _result(r):
    return dict(ok=r.ok, metrics=r.metrics, history=r.metrics_history,
                error=None if r.error is None else r.error.splitlines()[0])


# -- the cases of tests/test_train.py, through both packages ------------------

def case_execute(pkg, tmp_path):
    wg = _lib(pkg).WorkerGroup(2, resources_per_worker={"CPU": 1},
                               **_rt(pkg))
    try:
        return len(set(wg.execute(lambda: __import__("os").getpid())))
    finally:
        wg.shutdown()


def case_session_ranks(pkg, tmp_path):
    name = LIBS[pkg]

    def get_rank():
        import importlib

        s = importlib.import_module(name + ".session")
        return (s.get_world_rank(), s.get_world_size())

    wg = _lib(pkg).WorkerGroup(2, resources_per_worker={"CPU": 1},
                               **_rt(pkg))
    try:
        return sorted(wg.execute(get_rank))
    finally:
        wg.shutdown()


def case_basic_fit(pkg, tmp_path):
    def train_fn(config):
        import importlib

        session = importlib.import_module(config["lib"] + ".session")
        for step in range(config["steps"]):
            session.report({"step": step, "loss": 1.0 / (step + 1)})

    lib = _lib(pkg)
    r = lib.DataParallelTrainer(
        train_fn, train_loop_config={"steps": 3, "lib": LIBS[pkg]},
        scaling_config=lib.ScalingConfig(num_workers=2),
        run_config=lib.RunConfig(storage_path=str(tmp_path / pkg)),
        **_rt(pkg)).fit()
    out = _result(r)
    # 2 workers x 3 reports, in whichever order the workers interleave.
    out["history"] = sorted(tuple(sorted(m.items()))
                            for m in r.metrics_history)
    return out


def case_checkpointing(pkg, tmp_path):
    def train_fn(config):
        import importlib

        import numpy as np

        lib = importlib.import_module(config["lib"])
        for step, score in enumerate((3.0, 1.0, 4.0, 2.0)):
            ckpt = None
            if lib.session.get_world_rank() == 0:
                ckpt = lib.Checkpoint.from_dict(
                    {"model_step": step, "w": np.full(3, step, np.float32)})
            lib.session.report({"step": step, "score": score},
                               checkpoint=ckpt)

    lib = _lib(pkg)
    r = lib.DataParallelTrainer(
        train_fn, train_loop_config={"lib": LIBS[pkg]},
        scaling_config=lib.ScalingConfig(num_workers=1),
        run_config=lib.RunConfig(
            name="ckpt-test", storage_path=str(tmp_path / pkg),
            checkpoint_config=lib.CheckpointConfig(
                num_to_keep=2, checkpoint_score_attribute="score",
                checkpoint_score_order="min")),
        **_rt(pkg)).fit()
    root = os.path.join(r.path, "checkpoints")
    kept = {d: lib.Checkpoint.from_directory(os.path.join(root, d)).to_dict()
            for d in sorted(os.listdir(root))}
    return dict(_result(r), last=r.checkpoint.to_dict()["model_step"],
                kept={d: (c["model_step"], c["w"].tolist())
                      for d, c in kept.items()})


def case_error(pkg, tmp_path):
    def train_fn(config):
        raise ValueError("train blew up")

    lib = _lib(pkg)
    r = lib.DataParallelTrainer(
        train_fn, scaling_config=lib.ScalingConfig(num_workers=1),
        run_config=lib.RunConfig(storage_path=str(tmp_path / pkg)),
        **_rt(pkg)).fit()
    return _result(r)


def case_retries(pkg, tmp_path):
    def train_fn(config):
        import importlib
        import os

        session = importlib.import_module(config["lib"] + ".session")
        session.report({"attempt_step": 0})
        if not os.path.exists(config["marker"]):
            open(config["marker"], "w").close()
            raise RuntimeError("first attempt fails")
        session.report({"attempt_step": 1})

    lib = _lib(pkg)
    os.makedirs(tmp_path / pkg, exist_ok=True)
    r = lib.DataParallelTrainer(
        train_fn, train_loop_config={"lib": LIBS[pkg],
                                     "marker": str(tmp_path / pkg / "m")},
        scaling_config=lib.ScalingConfig(num_workers=1),
        run_config=lib.RunConfig(
            storage_path=str(tmp_path / pkg),
            failure_config=lib.FailureConfig(max_failures=1)),
        **_rt(pkg)).fit()
    return _result(r)


def case_async_save(pkg, tmp_path):
    from_lib = importlib.import_module(LIBS[pkg] + ".checkpoint")
    mgr = from_lib.CheckpointManager(str(tmp_path / pkg), num_to_keep=2)
    if pkg == "jax":
        arr = np.arange(8, dtype=np.float32)
    else:
        arr = torch.arange(8, dtype=torch.float32)
    fut = mgr.save_async(from_lib.Checkpoint.from_dict(
        {"params": arr, "step": 1}), step=1, metrics={"loss": 1.0})
    # Mutate the source in place after save_async returns: the snapshot
    # taken at the call must win.
    if pkg == "jax":
        arr += 100.0
    else:
        arr.add_(100.0)
    path = fut.result(timeout=30)
    mgr.wait_async()
    restored = from_lib.Checkpoint.from_directory(path).to_dict()
    return (np.asarray(restored["params"]).tolist(), restored["step"],
            os.path.basename(path), mgr.latest() is not None)


def case_batch_predictor(pkg, tmp_path):
    from ray_tpu.data import from_items

    lib = _lib(pkg)
    params = {"w": np.asarray([[2.0], [1.0]], np.float32),
              "b": np.asarray([0.5], np.float32)}
    ckpt = lib.Checkpoint.from_dict({"params": params})
    if pkg == "jax":
        def apply_fn(p, batch):
            import jax.numpy as jnp

            return {"pred": batch["x"] @ jnp.asarray(p["w"])
                    + jnp.asarray(p["b"])}

        predictor = lib.BatchPredictor.from_checkpoint(
            ckpt, lib.JaxPredictor, apply_fn=apply_fn)
        kw = {}
    else:
        def apply_fn(p, batch):
            return {"pred": batch["x"] @ p["w"] + p["b"]}

        predictor = lib.BatchPredictor.from_checkpoint(
            ckpt, lib.TorchPredictor, apply_fn=apply_fn, device="cpu")
        kw = {"runtime": ray_tpu.core}
    rows = [{"x": np.asarray([float(i), float(2 * i)], np.float32)}
            for i in range(12)]
    out = predictor.predict(from_items(rows, parallelism=3),
                            max_scoring_workers=2, **kw)
    return sorted(float(r["pred"][0]) for r in out.iter_rows())


CASES = {f.__name__[5:]: f for f in (
    case_execute, case_session_ranks, case_basic_fit, case_checkpointing,
    case_error, case_retries, case_async_save, case_batch_predictor)}


@pytest.mark.parametrize("case", list(CASES))
def test_train_case_matches_jax(rt_shared, tmp_path, case):
    want = CASES[case]("jax", tmp_path)
    got = CASES[case]("torch", tmp_path)
    assert got == want
    if case == "basic_fit":
        assert got["ok"] and len(got["history"]) == 6
    if case == "checkpointing":
        assert sorted(got["kept"]) == ["checkpoint_00000002",
                                       "checkpoint_00000004"]
    if case == "error":
        assert "train blew up" in got["error"]
    if case == "retries":
        assert got["ok"] and len(got["history"]) == 3


def test_fit_without_runtime_raises():
    from ray_tpu_torch.train import TorchTrainer

    with pytest.raises(ValueError, match="runtime="):
        TorchTrainer(lambda: None).fit()


# -- a tiny GPT-2 through JaxTrainer and TorchTrainer -------------------------

TINY = dict(vocab_size=128, max_seq=64, num_layers=2, num_heads=2,
            d_model=64)


def test_tiny_gpt2_through_both_trainers(rt_shared, tmp_path):
    from ray_tpu.train import JaxTrainer, ScalingConfig
    from ray_tpu_torch.train import TorchTrainer
    from ray_tpu_torch.train import ScalingConfig as TScalingConfig

    def jax_fn(config):
        import jax
        import jax.numpy as jnp

        from ray_tpu.models import gpt2
        from ray_tpu.parallel.mesh import MeshSpec
        from ray_tpu.train import session
        from ray_tpu.train.optim import adamw_lowmem
        from ray_tpu.train.step import build_sharded_train

        cfg = gpt2.GPT2Config(**config["tiny"], dtype=jnp.float32,
                              attention_impl="flash")
        init, step, _ = build_sharded_train(
            lambda k: gpt2.init_params(k, cfg),
            lambda p, b: gpt2.loss_fn(p, b, cfg),
            MeshSpec(dp=1).build(jax.devices()[:1]),
            optimizer=adamw_lowmem(1e-3, eps=1e-5))
        params, opt, n = init(jax.random.PRNGKey(0))
        for tokens in config["batches"]:
            params, opt, n, m = step(params, opt, n,
                                     {"tokens": jnp.asarray(tokens)})
            session.report({"loss": float(m["loss"])})

    def torch_fn(config):
        import torch

        from ray_tpu_torch import device
        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.models.convert import gpt2_params_from_numpy
        from ray_tpu_torch.train import session
        from ray_tpu_torch.train.optim import adamw_lowmem
        from ray_tpu_torch.train.step import build_train

        cfg = gpt2.GPT2Config(**config["tiny"], dtype=torch.float32,
                              attention_impl="flash")

        def init_fn(_generator):
            m = gpt2.GPT2(cfg)
            m.load_state_dict(gpt2_params_from_numpy(config["init"], cfg))
            return m

        with device.full_fp32():
            init, step = build_train(init_fn, lambda m, b: m.loss_fn(b),
                                     optimizer=adamw_lowmem(1e-3, eps=1e-5),
                                     device="cpu")
            model, opt, n = init(0)
            for tokens in config["batches"]:
                model, opt, n, m = step(model, opt, n,
                                        {"tokens": torch.from_numpy(tokens)})
                session.report({"loss": float(m["loss"])})

    jcfg = jgpt2.GPT2Config(**TINY, dtype=jnp.float32)
    init = jax.tree.map(np.asarray,
                        jgpt2.init_params(jax.random.PRNGKey(0), jcfg)[0])
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, 128, (2, 33)).astype(np.int32)
               for _ in range(3)]
    config = {"tiny": TINY, "batches": batches, "init": init}
    want = JaxTrainer(jax_fn, train_loop_config=config,
                      scaling_config=ScalingConfig(num_workers=1)).fit()
    got = TorchTrainer(torch_fn, train_loop_config=config,
                       scaling_config=TScalingConfig(num_workers=1),
                       runtime=ray_tpu.core).fit()
    assert want.ok and got.ok, (want.error, got.error)
    jl = [m["loss"] for m in want.metrics_history]
    tl = [m["loss"] for m in got.metrics_history]
    assert len(tl) == len(jl) == 3
    np.testing.assert_allclose(tl, jl, rtol=1e-5)


# -- checkpoints across the packages ------------------------------------------

def _tensors():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(4, 8, generator=g).to(torch.bfloat16),
            "b": torch.randn(8, generator=g),
            "count": torch.tensor(3, dtype=torch.int32),
            "layers": [torch.randn(2, 2, generator=g) for _ in range(2)]}


def test_port_checkpoint_reads_in_jax(tmp_path):
    import ray_tpu.train as jtrain

    t = _tensors()
    path = Checkpoint.from_dict({"x": 1, "__arrays__": t}).to_directory(
        str(tmp_path / "c"))
    assert sorted(os.listdir(path)) == ["arrays", "checkpoint_data.pkl",
                                        "meta.json"]
    got = jtrain.Checkpoint.from_directory(path).to_dict()
    assert got["x"] == 1
    arrays = got["__arrays__"]
    assert arrays["w"].dtype == np.float32  # bf16 widened, exactly
    np.testing.assert_array_equal(arrays["w"], t["w"].float().numpy())
    np.testing.assert_array_equal(arrays["b"], t["b"].numpy())
    assert arrays["count"].dtype == np.int32 and arrays["count"] == 3
    for a, b in zip(arrays["layers"], t["layers"]):
        np.testing.assert_array_equal(a, b.numpy())


def test_jax_dict_checkpoint_reads_in_port(tmp_path):
    import ray_tpu.train as jtrain

    params = {"w": np.random.default_rng(0).standard_normal(
        (3, 5)).astype(np.float32), "step": 7}
    path = jtrain.Checkpoint.from_dict({"params": params}).to_directory(
        str(tmp_path / "j"))
    got = Checkpoint.from_directory(path).to_dict()
    assert got["params"]["step"] == 7
    np.testing.assert_array_equal(got["params"]["w"], params["w"])


def test_restore_with_template_is_bit_exact(tmp_path):
    t = _tensors()
    from ray_tpu_torch.train import save_arrays

    save_arrays(str(tmp_path / "a"), t)
    plain = restore_arrays(str(tmp_path / "a"))
    assert isinstance(plain["w"], np.ndarray)
    assert plain["w"].dtype == np.float32
    back = restore_arrays(str(tmp_path / "a"), template=t)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), t["w"].view(torch.int16))
    assert back["count"].dtype == torch.int32 and int(back["count"]) == 3
    assert all(torch.equal(a, b) for a, b in zip(back["layers"],
                                                 t["layers"]))


def test_jax_orbax_directory_raises(tmp_path):
    import ray_tpu.train as jtrain

    path = jtrain.Checkpoint.from_dict(
        {"__arrays__": {"w": jnp.ones((2, 2))}}).to_directory(
        str(tmp_path / "o"))
    if os.path.exists(os.path.join(path, "arrays", "arrays.pkl")):
        pytest.skip("orbax is not installed: the JAX package fell back to "
                    "arrays.pkl")
    with pytest.raises(ValueError, match="orbax"):
        Checkpoint.from_directory(path).to_dict()


def test_jax_bf16_arrays_raise(tmp_path):
    import ml_dtypes

    os.makedirs(tmp_path / "b")
    with open(tmp_path / "b" / "arrays.pkl", "wb") as f:
        pickle.dump({"w": np.ones(3, ml_dtypes.bfloat16)}, f)
    with pytest.raises(ValueError, match="float32"):
        restore_arrays(str(tmp_path / "b"))


# -- two processes, one gloo world --------------------------------------------

SPMD = dict(vocab_size=128, max_seq=16, num_layers=2, num_heads=2,
            d_model=32)


def test_workergroup_spmd_two_processes(rt_shared):
    from ray_tpu.core.gcs_socket import ControlStoreProcess, build_native
    from ray_tpu_torch.train import WorkerGroup

    if not build_native():
        pytest.skip("native control store unavailable")

    def spmd_fn(config):
        import torch
        import torch.distributed as dist

        from ray_tpu.core.gcs_socket import ControlStoreClient
        from ray_tpu_torch import device
        from ray_tpu_torch.models import gpt2
        from ray_tpu_torch.parallel.bootstrap import Bootstrap
        from ray_tpu_torch.parallel.mesh import MeshSpec
        from ray_tpu_torch.train.session import get_session
        from ray_tpu_torch.train.step import (build_sharded_train,
                                              default_optimizer)

        ctx = get_session().ctx
        kv = ControlStoreClient(tuple(config["gcs_addr"]))
        bs = Bootstrap(kv, world_size=2, session="spmd-torch",
                       host_id=f"host-{ctx.world_rank}")
        rank = bs.claim_rank()
        bs.coordinator_address()
        bs.initialize_torch("gloo")
        try:
            cfg = gpt2.GPT2Config(**config["cfg"], dtype=torch.float32,
                                  attention_impl="reference")
            with device.full_fp32():
                init, step, _ = build_sharded_train(
                    lambda g: gpt2.GPT2(cfg, g), lambda m, b: m.loss_fn(b),
                    MeshSpec(dp=2).build("cpu"),
                    optimizer=default_optimizer(total_steps=4))
                model, opt, n = init(0)
                model, opt, n, met = step(
                    model, opt, n,
                    {"tokens": torch.from_numpy(config["tokens"])})
            return {"rank": rank, "processes": dist.get_world_size(),
                    "loss": float(met["loss"]),
                    "grad_norm": float(met["grad_norm"])}
        finally:
            dist.destroy_process_group()

    tokens = np.random.default_rng(0).integers(
        0, SPMD["vocab_size"], (4, SPMD["max_seq"] + 1)).astype(np.int64)
    store = ControlStoreProcess()
    try:
        group = WorkerGroup(2, runtime=ray_tpu.core)
        try:
            results = group.execute(spmd_fn, {"gcs_addr": store.address,
                                              "cfg": SPMD, "tokens": tokens})
        finally:
            group.shutdown()
    finally:
        store.stop()
    assert {r["rank"] for r in results} == {0, 1}
    assert all(r["processes"] == 2 for r in results)
    # One process, the whole batch, the same seed and recipe.
    from ray_tpu_torch.train.step import default_optimizer

    cfg = tgpt2.GPT2Config(**SPMD, dtype=torch.float32,
                           attention_impl="reference")
    with tdevice.full_fp32():
        init, step = build_train(lambda g: tgpt2.GPT2(cfg, g),
                                 lambda m, b: m.loss_fn(b),
                                 optimizer=default_optimizer(total_steps=4),
                                 device="cpu")
        model, opt, n = init(0)
        _, _, _, met = step(model, opt, n,
                            {"tokens": torch.from_numpy(tokens)})
    for r in results:
        np.testing.assert_allclose(r["loss"], float(met["loss"]), rtol=1e-6)
        np.testing.assert_allclose(r["grad_norm"], float(met["grad_norm"]),
                                   rtol=1e-5)


# -- HostGroup: the cases of tests/test_collective_p2p.py ---------------------

def test_host_group_send_recv_reduce_gather(rt_shared):
    rt = ray_tpu.core

    class Rank:
        def __init__(self, world, rank):
            import ray_tpu.core
            from ray_tpu_torch.parallel.collective import HostGroup

            self.g = HostGroup(world, rank, name="torch-t1",
                               runtime=ray_tpu.core)
            self.rank = rank

        def run(self):
            import torch

            g = self.g
            me = torch.full((3,), float(self.rank + 1))
            if self.rank == 0:
                g.send(me * 10, dst_rank=1, tag="x")
                red = g.reduce(me, dst_rank=0)
                gat = g.gather(me, dst_rank=0)
                g.barrier()
                return {"reduce": red.tolist(), "gather": gat.tolist()}
            got = g.recv(0, tag="x")
            assert g.reduce(me, dst_rank=0) is None
            assert g.gather(me, dst_rank=0) is None
            g.barrier()
            return {"recv": got.tolist(), "dtype": str(got.dtype)}

    cls = rt.remote(Rank)
    a, b = cls.remote(2, 0), cls.remote(2, 1)
    try:
        ra, rb = rt.get([a.run.remote(), b.run.remote()], timeout=120)
    finally:
        rt.kill(a)
        rt.kill(b)
    assert rb == {"recv": [10.0, 10.0, 10.0], "dtype": "torch.float32"}
    assert ra["reduce"] == [3.0, 3.0, 3.0]  # 1 + 2
    assert ra["gather"] == [[1.0] * 3, [2.0] * 3]


def test_host_group_repeated_sends_match_in_order(rt_shared):
    rt = ray_tpu.core

    class Peer:
        def __init__(self, world, rank):
            import ray_tpu.core
            from ray_tpu_torch.parallel.collective import HostGroup

            self.g = HostGroup(world, rank, name="torch-t2",
                               runtime=ray_tpu.core)

        def sender(self):
            import torch

            for i in range(5):
                self.g.send(torch.tensor([i], dtype=torch.int64), 1)
            return True

        def receiver(self):
            return [int(self.g.recv(0)[0]) for _ in range(5)]

    cls = rt.remote(Peer)
    s, r = cls.remote(2, 0), cls.remote(2, 1)
    try:
        ok, got = rt.get([s.sender.remote(), r.receiver.remote()],
                         timeout=120)
    finally:
        rt.kill(s)
        rt.kill(r)
    assert ok and got == [0, 1, 2, 3, 4]
