"""The port's data feed (``ray_tpu_torch.data``) and ``ActorPool``
(``ray_tpu_torch.util.actor_pool``) against the JAX package's: ``to_torch``
gives ``Dataset.to_jax``'s batches, the numpy block conversion gives
``BlockAccessor``'s, and the pool on the injected runtime maps as the JAX
package's pool does. Exact equality throughout: nothing is computed.
"""


import numpy as np
import pytest
import torch

import ray_tpu.core
from ray_tpu.data import from_items
from ray_tpu.data.block import BlockAccessor
from ray_tpu.util.actor_pool import ActorPool as JaxActorPool
from ray_tpu_torch.data import block_to_format, block_to_numpy, to_torch
from ray_tpu_torch.util.actor_pool import ActorPool
from torch_time_limit import time_limit

LIMIT_S = 120  # each test's own limit (torch_time_limit)


_limit = time_limit(LIMIT_S)


def _rows(n):
    rng = np.random.default_rng(0)
    return [{"x": rng.standard_normal(3).astype(np.float32),
             "y": np.int64(i), "z": rng.integers(0, 9, (2, 2))}
            for i in range(n)]


@pytest.mark.parametrize("drop_last", [True, False])
def test_to_torch_matches_to_jax(rt_shared, drop_last):
    ds = from_items(_rows(23), parallelism=3)
    want = list(ds.to_jax(batch_size=5, drop_last=drop_last))
    got = list(to_torch(ds, batch_size=5, device="cpu",
                        drop_last=drop_last))
    assert len(got) == len(want) == (4 if drop_last else 5)
    # JAX narrows int64 to int32 (x64 off); the port keeps numpy's dtype.
    host = list(ds.iter_batches(batch_size=5, batch_format="numpy",
                                drop_last=drop_last))
    for g, w, h in zip(got, want, host):
        assert set(g) == set(w) == set(h)
        for k in w:
            assert g[k].device.type == "cpu"
            assert g[k].dtype == torch.from_numpy(np.array(h[k])).dtype
            np.testing.assert_array_equal(g[k].numpy(), np.asarray(w[k]))


@pytest.mark.parametrize("kind", ["rows", "values", "columns", "empty"])
def test_block_to_numpy_matches_block_accessor(kind):
    block = {"rows": _rows(4), "values": [1.5, 2.5, 3.5], "empty": [],
             "columns": {"a": np.arange(3), "b": np.ones((3, 2))}}[kind]
    want = BlockAccessor.for_block(block).to_format("numpy")
    got = block_to_format(block, "numpy")
    assert block_to_numpy(block).keys() == got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    with pytest.raises(ValueError, match="numpy batches only"):
        block_to_format(block, "pandas")


def test_actor_pool_on_injected_runtime(rt_shared):
    class _Doubler:  # by value: the workers need not import this module
        def double(self, x):
            return 2 * x

    rt = ray_tpu.core
    actors = [rt.remote(_Doubler).remote() for _ in range(2)]
    try:
        fn = lambda a, v: a.double.remote(v)  # noqa: E731
        # The JAX package's pool frees no actor once a map has more than
        # twice as many values as actors (its _wait_one waits on a ref it
        # already freed): three values, where it still maps.
        want = list(JaxActorPool(actors).map(fn, range(3)))
        assert list(ActorPool(actors, rt).map(fn, range(3))) == want
        assert list(ActorPool(actors, rt).map(fn, range(7))) == [
            2 * v for v in range(7)]
        got = sorted(ActorPool(actors, rt).map_unordered(fn, range(7)))
        assert got == [2 * v for v in range(7)]
    finally:
        for a in actors:
            rt.kill(a)
