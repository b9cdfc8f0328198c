"""nfs_tpu_torch's mantaflow ``.uni`` particle codecs (PB02 particle
systems, PD01 particle data) against the JAX package's, in both
directions: a file written by one package is read identically by both,
the two writers emit the same layout, and both readers take the same
hand-built byte fixtures (tests/test_io.py's) and refuse the same wrong
magics. Exact comparisons: the codecs move bytes, they compute nothing."""

import dataclasses
import gzip
import struct

import numpy as np
import pytest

from nfs_tpu.io import uni as jax_uni
from nfs_tpu_torch.io import uni as port_uni

PACKAGES = {"jax": jax_uni, "port": port_uni}
HEADER = "<6i256s4xQ"   # PB02 / PD01, naturally aligned
HEADER_BYTES = 4 + struct.calcsize(HEADER)


def _read_both(reader: str, path, **kw):
    """(array, header as a dict) from each package's ``reader``; the two
    must agree exactly."""
    got = [getattr(mod, reader)(str(path), **kw) for mod in PACKAGES.values()]
    (a, ha), (b, hb) = got
    assert a.dtype == b.dtype and np.array_equal(a, b)
    assert dataclasses.asdict(ha) == dataclasses.asdict(hb)
    return a, dataclasses.asdict(ha)


def _pb02_fixture(n=7, info=b"parts", timestamp=42):
    rng = np.random.default_rng(1)
    pos_xyz = rng.random((n, 3)).astype(np.float32) * 10
    rec = np.zeros((n, 4), np.float32)
    rec[:, :3] = pos_xyz
    head = struct.pack(HEADER, n, 16, 8, 16, 0, 16, info.ljust(256, b"\x00"),
                       timestamp)
    return b"PB02" + head + rec.tobytes(), pos_xyz


def _pd01_fixture(kind):
    if kind == "float":
        vals, elem, bpe = np.linspace(0, 1, 9).astype(np.float32), 1, 4
    elif kind == "int":
        vals, elem, bpe = np.arange(-4, 13, dtype=np.int32), 0, 4
    else:  # Vec3
        vals = np.random.default_rng(10).random((5, 3)).astype(np.float32)
        elem, bpe = 2, 12
    head = struct.pack(HEADER, len(vals), 0, 0, 0, elem, bpe,
                       b"density".ljust(256, b"\x00"), 7)
    return b"PD01" + head + vals.tobytes(), vals


@pytest.mark.parametrize("compress", [True, False])
@pytest.mark.parametrize("manta_order", [False, True])
def test_pb02_fixture_read_alike(tmp_path, manta_order, compress):
    """The PB02 byte fixture (BasicParticleData: Vec3 position and an
    int32 flag, 16 bytes a particle), gzip-wrapped or raw, in framework
    (z, y, x) or mantaflow (x, y, z) order."""
    blob, pos_xyz = _pb02_fixture()
    path = tmp_path / "p.uni"
    path.write_bytes(gzip.compress(blob) if compress else blob)
    got, header = _read_both("read_uni_particles", path,
                             manta_order=manta_order)
    assert np.array_equal(got, pos_xyz if manta_order else pos_xyz[:, ::-1])
    assert header["magic"] == "PB02" and header["timestamp"] == 42
    assert header["dim"] == (16, 8, 16) and header["info"] == "parts"


def test_pb02_packed_header_read_alike(tmp_path):
    """A header without the alignment padding is taken by both readers."""
    blob, pos_xyz = _pb02_fixture()
    packed = (blob[:4] + blob[4:4 + 280] + blob[4 + 284:])
    path = tmp_path / "p.uni"
    path.write_bytes(packed)
    got, _ = _read_both("read_uni_particles", path)
    assert np.array_equal(got, pos_xyz[:, ::-1])


@pytest.mark.parametrize("kind", ["float", "int", "vec3"])
def test_pd01_fixture_read_alike(tmp_path, kind):
    blob, vals = _pd01_fixture(kind)
    path = tmp_path / "pd.uni"
    path.write_bytes(gzip.compress(blob))
    got, header = _read_both("read_uni_pdata", path)
    assert got.dtype == vals.dtype and np.array_equal(got, vals)
    assert header["magic"] == "PD01" and header["info"] == "density"


@pytest.mark.parametrize("writer", sorted(PACKAGES))
@pytest.mark.parametrize("manta_order", [False, True])
def test_particles_written_by_either_read_by_both(tmp_path, writer,
                                                  manta_order):
    pos = (np.random.default_rng(8).random((30, 3)) * 10).astype(np.float32)
    path = tmp_path / "p.uni"
    PACKAGES[writer].write_uni_particles(str(path), pos, grid_dim=(16, 8, 12),
                                         manta_order=manta_order)
    got, header = _read_both("read_uni_particles", path,
                             manta_order=manta_order)
    assert np.array_equal(got, pos)
    assert header["magic"] == "PB02" and header["dim"] == (12, 8, 16)


@pytest.mark.parametrize("writer", sorted(PACKAGES))
@pytest.mark.parametrize("kind", ["float", "int", "vec3"])
def test_pdata_written_by_either_read_by_both(tmp_path, writer, kind):
    _, vals = _pd01_fixture(kind)
    path = tmp_path / "pd.uni"
    PACKAGES[writer].write_uni_pdata(str(path), vals, compress=False)
    got, _ = _read_both("read_uni_pdata", path)
    assert got.dtype == vals.dtype and np.array_equal(got, vals)


@pytest.mark.parametrize("write,arr", [
    ("write_uni_particles", np.arange(24, dtype=np.float32).reshape(8, 3)),
    ("write_uni_pdata", np.arange(8, dtype=np.int32)),
    ("write_uni_pdata", np.linspace(0, 1, 8).astype(np.float32)),
    ("write_uni_pdata", np.arange(24, dtype=np.float32).reshape(8, 3)),
])
def test_writers_emit_the_same_layout(tmp_path, write, arr):
    """The two writers' files are byte for byte the same, but for the
    timestamp (the header's last 8 bytes) and gzip's own header."""
    blobs = []
    for name, mod in PACKAGES.items():
        path = tmp_path / f"{name}.uni"
        getattr(mod, write)(str(path), arr, info="same")
        blobs.append(gzip.decompress(path.read_bytes()))
    a, b = blobs
    assert len(a) == len(b)
    assert a[:HEADER_BYTES - 8] == b[:HEADER_BYTES - 8]
    assert a[HEADER_BYTES:] == b[HEADER_BYTES:]


@pytest.mark.parametrize("reader,magic", [
    ("read_uni_particles", b"PD01"), ("read_uni_particles", b"MNT3"),
    ("read_uni_pdata", b"PB02"), ("read_uni_pdata", b"XXXX"),
])
def test_wrong_magic_raises_alike(tmp_path, reader, magic):
    path = tmp_path / "bad.uni"
    path.write_bytes(magic + b"\x00" * 300)
    messages = []
    for mod in PACKAGES.values():
        with pytest.raises(ValueError) as err:
            getattr(mod, reader)(str(path))
        messages.append(str(err.value))
    assert messages[0] == messages[1] and repr(magic.decode()) in messages[0]
