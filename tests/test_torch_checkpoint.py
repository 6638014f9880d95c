"""The port's npz checkpoints (``cirkit_tpu_torch.utils.checkpoint``)
against the JAX package's (``cirkit_tpu.utils.checkpoint``), on the CPU:
a store saved by either loads in the other by slot name, the data
fingerprints agree, and bfloat16 leaves round-trip."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cirkit_tpu.utils import checkpoint as J
from cirkit_tpu_torch.utils import checkpoint as T


def _store(seed=0):
    rng = np.random.default_rng(seed)
    return {f"p{i}": rng.normal(size=(3, 2, 4)) for i in (12, 3, 40)}


def test_jax_store_loads_in_the_port(tmp_path):
    arrays = _store()
    J.save_store(tmp_path / "s.npz", {k: jnp.asarray(v) for k, v in arrays.items()})
    plain = T.load_store(tmp_path / "s.npz")
    assert set(plain) == set(arrays)
    like = {k: torch.zeros(v.shape, dtype=torch.float64) for k, v in arrays.items()}
    loaded = T.load_store(tmp_path / "s.npz", like=like)
    for k, v in arrays.items():
        np.testing.assert_array_equal(plain[k], v)
        assert isinstance(loaded[k], torch.Tensor) and loaded[k].dtype == torch.float64
        np.testing.assert_array_equal(loaded[k].numpy(), v)


def test_port_store_loads_in_jax(tmp_path):
    arrays = _store(1)
    tree = {"store": {k: torch.as_tensor(v) for k, v in arrays.items()},
            "steps": [np.int64(3), torch.tensor(2.5)]}
    T.save_store(tmp_path / "s.npz", tree)
    back = J.load_store(tmp_path / "s.npz")
    for k, v in arrays.items():
        np.testing.assert_array_equal(back["store"][k], v)
    assert int(back["steps"][0]) == 3 and float(back["steps"][1]) == 2.5
    with np.load(tmp_path / "s.npz") as data:
        assert '[["d", "store"], ["d", "p12"]]' in data.files


@pytest.mark.parametrize("shape,dtype", [((7, 5), np.int64), ((3 << 18,), np.float32),
                                         ((0, 4), np.uint8)])
def test_data_fingerprint_equals_jax(shape, dtype):
    data = np.random.default_rng(2).integers(0, 255, shape).astype(dtype)
    fp = T.data_fingerprint(data)
    assert isinstance(fp, np.uint64) and fp == J.data_fingerprint(data)
    assert T.data_fingerprint(data[::-1].copy()) != fp or data.size <= 1 or shape[0] == 0


def test_bf16_leaves_round_trip(tmp_path):
    mu = torch.randn(4, 8).to(torch.bfloat16)
    T.save_store(tmp_path / "m.npz", {"mu": mu})
    with np.load(tmp_path / "m.npz") as data:
        assert data['[["d", "mu"]]'].dtype == np.float32  # widened: npz has no bf16
    back = T.load_store(tmp_path / "m.npz", like={"mu": torch.zeros(4, 8, dtype=torch.bfloat16)})
    assert back["mu"].dtype == torch.bfloat16 and torch.equal(back["mu"], mu)


def test_load_with_like_rebuilds_structure_and_checks_paths(tmp_path):
    tree = {"a": [torch.ones(2), (np.zeros(3), np.float64(1.5))], "b": torch.arange(3)}
    T.save_store(tmp_path / "t.npz", tree)
    like = {"a": [torch.zeros(2), (np.zeros(3, np.float32), np.float64(0))], "b": torch.zeros(3)}
    back = T.load_store(tmp_path / "t.npz", like=like)
    assert isinstance(back["a"][1], tuple) and back["a"][1][0].dtype == np.float32
    assert back["b"].dtype == torch.float32 and torch.equal(back["b"], torch.arange(3.0))
    with pytest.raises(KeyError, match="no entry"):
        T.load_store(tmp_path / "t.npz", like={"c": torch.zeros(1)})


def test_training_state_is_atomic_and_optional(tmp_path):
    path = tmp_path / "ck"
    assert T.training_state_path(path) == str(path) + ".npz"
    assert T.load_training_state(path) is None
    T.save_training_state(path, {"step": np.int64(4), "w": torch.ones(2)})
    assert not (tmp_path / "ck.npz.tmp.npz").exists()
    state = T.load_training_state(path)
    assert int(state["step"]) == 4 and np.array_equal(state["w"], np.ones(2))
    assert J.load_training_state(path, like={"step": np.int64(0), "w": jnp.zeros(2)}) is not None
