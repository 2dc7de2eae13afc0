"""Port parity of the map tools: `kissmpc_tpu_torch.obstacles.mapping`, the
port's `native` library, and `obstacles.concatenate`.

Each is held against its `kissmpc_tpu` counterpart on inputs made from a
numpy seed.  The PGM reader, the numpy EDT, the packing and the world-frame
conversion are copies, so they must agree exactly; the native EDT is
float32, so it is held to the numpy oracle within 1e-5 px (the reference's
own tolerance in tests/test_native.py).  The port's library must build into
the repository's git-ignored `build/` directory, not beside its sources, and
load here, where g++ is present.
"""

import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from kissmpc_tpu import native as j_native
from kissmpc_tpu.obstacles import mapping as j_mapping
from kissmpc_tpu.obstacles.obstacles import ObstacleSet as JSet
from kissmpc_tpu.obstacles.obstacles import concatenate as j_concatenate
from kissmpc_tpu_torch import native as t_native
from kissmpc_tpu_torch.obstacles import ObstacleSet as TSet
from kissmpc_tpu_torch.obstacles import concatenate as t_concatenate
from kissmpc_tpu_torch.obstacles import mapping as t_mapping


ROOT = t_native.BUILD_DIR.parents[2]


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: small tensors, beside other test workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


@pytest.fixture(scope="module")
def native_lib():
    if shutil.which("g++") is None:
        pytest.skip("needs g++ to build the native library")
    lib = t_native.load()
    assert lib is not None, "g++ is present, so the port's native library must load"
    return lib


def test_native_library_lands_under_build(native_lib):
    path = t_native.library_path()
    assert path.exists()
    assert path.parent == ROOT / "build" / "kissmpc_tpu_torch" / "native"
    assert not list((ROOT / "kissmpc_tpu_torch" / "native").glob("*.so"))
    assert t_native.available()


def _maps(seed, count=3, shape=(40, 60)):
    rng = np.random.default_rng(seed)
    return [(rng.random(shape) > 0.4).astype(np.uint8) for _ in range(count)]


def test_numpy_edt_matches_reference():
    for fg in _maps(0) + [np.zeros((8, 8), np.uint8), np.ones((8, 8), np.uint8)]:
        np.testing.assert_array_equal(t_mapping.distance_transform_edt(fg),
                                      j_mapping.distance_transform_edt(fg))


def test_native_edt_matches_oracles(native_lib):
    for fg in _maps(1):
        got = t_native.edt(fg)
        np.testing.assert_allclose(got, t_mapping.distance_transform_edt(fg), atol=1e-5)
        if j_native.available():
            np.testing.assert_array_equal(got, j_native.edt(fg))


def test_read_pgm_matches_reference(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (13, 17), dtype=np.uint8)
    path = tmp_path / "map.pgm"
    path.write_bytes(b"P5\n# a comment\n17 13\n255\n" + img.tobytes())
    np.testing.assert_array_equal(t_mapping.read_pgm(path), img)
    np.testing.assert_array_equal(t_mapping.read_pgm(path), j_mapping.read_pgm(path))
    lab = tmp_path / "lab.pgm"
    chip_smoke.write_synthetic_map(lab, shape=(160, 240), seed=4)
    np.testing.assert_array_equal(t_mapping.read_pgm(lab), j_mapping.read_pgm(lab))


@pytest.mark.parametrize("use_native", [True, False], ids=["native", "numpy"])
def test_pack_circles_matches_reference(tmp_path, use_native, native_lib):
    lab = tmp_path / "lab.pgm"
    chip_smoke.write_synthetic_map(lab, shape=(160, 240), seed=5)
    img = t_mapping.read_pgm(lab)
    got = t_mapping.pack_circles(img, min_radius=3.0, max_circles=40, use_native=use_native)
    ref = j_mapping.pack_circles(img, min_radius=3.0, max_circles=40, use_native=use_native)
    assert len(got[1]) == len(ref[1]) > 5
    np.testing.assert_array_equal(got[0], ref[0])
    np.testing.assert_array_equal(got[1], ref[1])


def test_native_packing_matches_numpy_path(native_lib):
    img = np.full((64, 64), 255, dtype=np.uint8)
    yy, xx = np.mgrid[0:64, 0:64]
    for cy, cx, r in [(20, 20, 11), (45, 50, 7)]:
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = 0
    cn, rn = t_mapping.pack_circles(img, min_radius=3.0, use_native=True)
    cp, rp = t_mapping.pack_circles(img, min_radius=3.0, use_native=False)
    assert len(rn) == len(rp)
    np.testing.assert_allclose(cn, cp, atol=1e-4)
    np.testing.assert_allclose(rn, rp, atol=1e-4)


def test_circles_to_world_matches_reference():
    rng = np.random.default_rng(2)
    centers, radii = rng.uniform(0, 500, (7, 2)), rng.uniform(1, 20, 7)
    for kw in ({}, {"resolution": 0.1, "origin": (-3.0, 2.0)}, {"map_height_px": 480}):
        got = t_mapping.circles_to_world(centers, radii, **kw)
        ref = j_mapping.circles_to_world(centers, radii, **kw)
        for a, b in zip(got, ref):
            np.testing.assert_array_equal(a, b)


def test_mailbox_roundtrip(native_lib):
    mb = t_native.Mailbox.create(8)
    assert mb is not None
    assert mb.read() == (None, 0)
    assert mb.publish(np.arange(5.0)) == 1
    val, v = mb.read()
    assert v == 1
    np.testing.assert_array_equal(val, np.arange(5.0))
    with pytest.raises(ValueError):
        mb.publish(np.zeros(9))
    mb.close()


def test_concatenate_matches_reference():
    rng = np.random.default_rng(3)

    def arrays(k):
        return dict(position=rng.normal(size=(k, 2)), radius=rng.uniform(0.1, 0.4, k),
                    orientation=rng.uniform(-3, 3, k), linear_velocity=rng.uniform(0, 1, k),
                    angular_velocity=rng.normal(size=k), active=np.ones(k))

    a, b = arrays(3), arrays(2)
    ref = j_concatenate(JSet(**{k: jnp.asarray(v) for k, v in a.items()}),
                        JSet(**{k: jnp.asarray(v) for k, v in b.items()}))
    got = t_concatenate(TSet(**{k: torch.tensor(v) for k, v in a.items()}),
                        TSet(**{k: torch.tensor(v) for k, v in b.items()}))
    assert got.size == 5
    for name in TSet._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(ref, name)))
