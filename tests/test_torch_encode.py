"""The 2-bit codec, the seeded generators and the .npz container: port vs
JAX.

``swtpu_torch.core.encode`` (numpy, copied) against ``swtpu.core.encode``
on the same seeds; the torch device codec (``kernels/unpack.py``, on the
CPU) against JAX's; ``.npz`` files written by either package, with
in-length N (the ``ambig`` mask), loaded by both, on the numpy path and
on the torch path (``device="cpu"``). Seed 10000, tolerance 0.
"""

import jax  # noqa: F401  (conftest keeps JAX on the CPU)
import numpy as np
import pytest
import torch

from swtpu.core import encode as jax_encode
from swtpu.core import io as jax_io
from swtpu.kernels.xla import unpack as jax_unpack
from swtpu_torch.core import encode as port_encode
from swtpu_torch.core import io as port_io
from swtpu_torch.kernels import unpack as port_unpack


def test_pack_unpack_equal_jax():
    rng = np.random.default_rng(10000)
    for shape in [(4,), (3, 8), (2, 5, 64)]:
        s = rng.integers(0, 4, size=shape).astype(np.uint8)
        p = port_encode.pack_2bit(s)
        np.testing.assert_array_equal(p, jax_encode.pack_2bit(s))
        assert p.dtype == np.uint8
        np.testing.assert_array_equal(port_encode.unpack_2bit(p), s)
        np.testing.assert_array_equal(
            port_encode.unpack_2bit(p), jax_encode.unpack_2bit(p)
        )
    with pytest.raises(ValueError, match="multiple of 4"):
        port_encode.pack_2bit(np.zeros(6, np.uint8))


def test_generators_equal_jax():
    a, b = np.random.default_rng(10000), np.random.default_rng(10000)
    np.testing.assert_array_equal(
        port_encode.random_dna(a, (7, 33)), jax_encode.random_dna(b, (7, 33))
    )
    src = port_encode.random_dna(a, (90,))
    jax_encode.random_dna(b, (90,))
    for kw in ({}, dict(p_mismatch=0.02, p_insert=0, p_delete=0),
               dict(out_len=120), dict(out_len=40)):
        np.testing.assert_array_equal(
            port_encode.mutate(a, src, **kw), jax_encode.mutate(b, src, **kw)
        )
    padded = np.concatenate([src[:20], np.array([4, 5, 4], np.uint8)])
    padded[3] = 4
    for length in (None, 20, 23):
        np.testing.assert_array_equal(
            port_encode.revcomp(padded, length),
            jax_encode.revcomp(padded, length),
        )


def test_device_codec_on_cpu_equals_jax():
    rng = np.random.default_rng(10000)
    s = rng.integers(0, 4, size=(4, 256)).astype(np.uint8)
    p = port_encode.pack_2bit(s)
    got = port_unpack.unpack_2bit_device(p, "cpu")
    assert got.dtype == torch.uint8 and got.device.type == "cpu"
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(jax_unpack.unpack_2bit_device(p))
    )
    noisy = s.copy()
    noisy[:, ::7] = 4  # codes above 3 keep their low two bits, as in JAX
    packed = port_unpack.pack_2bit_device(torch.from_numpy(noisy), "cpu")
    np.testing.assert_array_equal(
        packed.numpy(), np.asarray(jax_unpack.pack_2bit_device(noisy))
    )
    np.testing.assert_array_equal(
        port_unpack.pack_2bit_device(s, "cpu").numpy(), p
    )


def _batch():
    """Five DNA sequences of mixed length with in-length N and garbage
    past the lengths."""
    rng = np.random.default_rng(10000)
    lens = np.array([13, 1, 22, 0, 17], np.int64)
    batch = rng.integers(0, 4, size=(5, 22)).astype(np.uint8)
    batch[0, 4] = 4
    batch[2, [0, 9, 21]] = 4
    batch[4, 16] = 7
    batch[1, 5:] = 4
    return [f"r{i}" for i in range(5)], batch, lens


WRITERS = {"jax": jax_io.save_packed_batch, "port": port_io.save_packed_batch}
LOADS = ["numpy", "cpu_tensor", "pad_to_8", "pad_code_5"]


@pytest.mark.parametrize("load", LOADS)
@pytest.mark.parametrize("writer", list(WRITERS))
def test_npz_container_loads_identically(writer, load, tmp_path):
    names, batch, lens = _batch()
    path = str(tmp_path / "b.npz")
    WRITERS[writer](path, names, batch, lens)
    kw = {"pad_to_8": dict(pad_to=8), "pad_code_5": dict(pad_code=5)}.get(load, {})
    want = jax_io.load_packed_batch(path, **kw)
    assert "ambig" in np.load(path, allow_pickle=True).files
    port_kw = dict(kw, device="cpu") if load == "cpu_tensor" else kw
    got = port_io.load_packed_batch(path, **port_kw)
    assert got[0] == want[0] == names
    np.testing.assert_array_equal(got[2], want[2])
    if load == "cpu_tensor":
        assert isinstance(got[1], torch.Tensor) and got[1].device.type == "cpu"
        got_batch = got[1].numpy()
    else:
        assert isinstance(got[1], np.ndarray)
        got_batch = got[1]
    np.testing.assert_array_equal(got_batch, np.asarray(want[1]))
    # in-length N comes back as the pad code, never as 'A'
    pad = kw.get("pad_code", 4)
    assert got_batch[0, 4] == pad and got_batch[2, 21] == pad


def test_npz_clean_file_has_no_mask_and_round_trips(tmp_path):
    rng = np.random.default_rng(10000)
    batch = rng.integers(0, 4, size=(3, 10)).astype(np.uint8)
    lens = np.array([10, 7, 3])
    for name, save in WRITERS.items():
        path = str(tmp_path / f"{name}.npz")
        save(path, ["a", "b", "c"], batch, lens)
        assert "ambig" not in np.load(path, allow_pickle=True).files
        _, got, got_lens = port_io.load_packed_batch(path)
        np.testing.assert_array_equal(got_lens, lens)
        for i, n in enumerate(lens):
            np.testing.assert_array_equal(got[i, :n], batch[i, :n])
            assert (got[i, n:] == 4).all()
