"""Weights and checkpoints across packages: the port's msgpack decoder
against flax's, params_from_flax's key checks, and a checkpoint written
by the JAX trainer served by the port's InferenceEngine on the CPU with
the msgpack package blocked (energies and forces against the JAX model,
1e-4 relative as in test_torch_model.py)."""

import sys

import flax.serialization as fser
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_model import _jax_forward, _jax_params, _kw, _molecules
from xequinet_tpu import keys
from xequinet_tpu.data.batching import collate
from xequinet_tpu.training.trainer import save_checkpoint
from xequinet_torch import convert
from xequinet_torch.data.datapoint import Datapoint
from xequinet_torch.models.model import init_params, resolve_model
from xequinet_torch.run.inference import InferenceEngine


@pytest.fixture(autouse=True)
def _torch_threads():
    torch.set_num_threads(2)


def _assert_tree_equal(a, b):
    if isinstance(b, dict):
        assert sorted(a) == sorted(b)
        for k in b:
            _assert_tree_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(np.asarray(a, dtype=np.float64),
                                      np.asarray(b, dtype=np.float64))


def test_msgpack_decoder_matches_flax(rng, monkeypatch):
    tree = {
        "a": rng.normal(size=(3, 4)).astype(np.float32),
        "b": {"c": np.arange(7, dtype=np.int32), "d": np.array([True, False]),
              "e": jnp.asarray(rng.normal(size=(5,)), dtype=jnp.bfloat16),
              "f": np.float32(2.5), "g": rng.normal(size=(300,)).astype(np.float64)},
        "h": 3, "i": -7, "j": 1.25, "k": "text", "l": None, "m": 70000,
        "n": -200, "o": 2 ** 40,
    }
    monkeypatch.setattr(fser, "MAX_CHUNK_SIZE", 256)  # forces chunked leaves
    blob = fser.msgpack_serialize(jax.tree_util.tree_map(lambda x: x, tree))
    want = fser.msgpack_restore(blob)
    got = convert.msgpack_restore(blob)
    for k in ("h", "i", "j", "k", "l", "m", "n", "o"):
        assert got[k] == want[k]
    for k in ("a", "b"):
        _assert_tree_equal(got[k], want[k])


def test_params_from_flax_checks_keys(rng):
    batch = collate(_molecules(rng, 2))
    params = jax.tree_util.tree_map(np.asarray, _jax_params(_kw(False), batch))
    module, _, _ = resolve_model("xpainn", **_kw(False))
    sd = convert.params_from_flax(params, module)
    assert sd["blocks.1.Dense_0.weight"].shape == params["blocks_1"]["Dense_0"]["kernel"].T.shape
    bad = dict(params)
    bad["blocks_9"] = {"Dense_0": {"kernel": np.zeros((2, 2), np.float32)}}
    with pytest.raises(KeyError):
        convert.params_from_flax(bad, module)
    short = {k: v for k, v in params.items() if k != "blocks_2"}
    with pytest.raises(KeyError):
        convert.params_from_flax(short, module)


def test_jax_checkpoint_served_by_port_without_msgpack(rng, tmp_path, monkeypatch):
    dps = _molecules(rng)
    batch = collate(dps)
    kw = _kw(False)
    params = _jax_params(kw, batch)
    ema = jax.tree_util.tree_map(lambda a: a * 1.01, params)
    path = str(tmp_path / "ckpt.pkl")
    save_checkpoint(path, params, {"model_name": "xpainn", "model_kwargs": kw},
                    ema_params=ema)
    monkeypatch.setitem(sys.modules, "msgpack", None)
    with pytest.raises(ImportError):
        import msgpack  # noqa: F401
    engine = InferenceEngine(path, device="cpu")
    got = engine.forward_batch(batch)
    want = _jax_forward(kw, ema, batch)
    n_g = len(dps)
    for k in (keys.TOTAL_ENERGY, keys.FORCES):
        g = got[k].numpy()[:n_g] if k == keys.TOTAL_ENERGY else got[k].numpy()
        w = np.asarray(want[k])[:n_g] if k == keys.TOTAL_ENERGY else np.asarray(want[k])
        assert np.abs(g - w).max() <= 1e-4 * np.abs(w).max()
    res = engine.predict(dps)
    assert [r[keys.FORCES].shape for r in res] == [(d.num_atoms, 3) for d in dps]


def test_engine_kernel_layout_fallback_only_on_cpu(rng):
    """A structure larger than the kernel window: the CPU engine collates
    it without the slot layout (as the JAX engine does) and agrees with
    the plain route; for the card the engine refuses the batch."""
    dps = _molecules(rng, 2) + [Datapoint(rng.integers(1, 9, 30).astype(np.int32),
                                          rng.normal(size=(30, 3)) * 2.0)]
    kw = dict(_kw(False), use_pallas_scatter="mega", pallas_layout=(8, 8, 4, 16))
    module, extra, cutoff = resolve_model("xpainn", **kw)
    init_params(module, seed=0)
    mega = InferenceEngine(module=module, model_kwargs=kw, extra=extra, cutoff=cutoff,
                           device="cpu")
    plain = InferenceEngine(module=module, model_kwargs=_kw(False), extra=extra,
                            cutoff=cutoff, device="cpu")
    got, want = mega.predict(dps), plain.predict(dps)
    f_got = np.concatenate([r[keys.FORCES] for r in got])
    f_want = np.concatenate([r[keys.FORCES] for r in want])
    # the same ops on the same batch; CPU reductions may sum in another order
    assert np.abs(f_got - f_want).max() <= 1e-5 * np.abs(f_want).max()
    mega.device = torch.device("cuda")  # collate alone: no tensor goes there
    with pytest.raises(ValueError, match="slot layout"):
        mega.collate([mega.transform(d) for d in dps])


def test_engine_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    module, extra, cutoff = resolve_model("xpainn", **_kw(False))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        InferenceEngine(module=module, model_kwargs=_kw(False), extra=extra, cutoff=cutoff)
