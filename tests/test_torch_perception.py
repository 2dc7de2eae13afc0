"""Port parity of perception: `kissmpc_tpu_torch.perception` on the CPU
against `kissmpc_tpu.perception` (JAX on the CPU), on inputs made from a
numpy seed.

Tolerances: the masks of `range_filter`, `project_points` and
`points_in_mask` exactly equal; `SE3` within 1e-6; DBSCAN labels and
cluster counts exactly equal (P=64 and 128, B<=8, the JAX side vmapped);
`largest_cluster_mean` centres within 1e-6 m and `found` exact; the tracker
over 20 frames with spawns, misses and retirements: `track_id`, `active`,
`hits`, `misses`, `age` and `next_id` exact, positions within 1e-6 m,
velocities within 1e-5 m/s (they divide by dt); `to_obstacles` within 1e-6;
`pipeline.step` over a recorded synthetic walk at B=4 against the JAX
vmap with the same tolerances; the blob detector's and the segmenter's
masks exactly equal (the segmenter's weights carried by
`bridge.segnet_from_numpy`).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kissmpc_tpu.io.frames import FrameReplayer as JReplayer
from kissmpc_tpu.io.frames import record_synthetic_walk as j_record_walk
from kissmpc_tpu.perception import clustering as jc
from kissmpc_tpu.perception import detectors as jd
from kissmpc_tpu.perception import pipeline as jp
from kissmpc_tpu.perception import projection as jproj
from kissmpc_tpu.perception import segnet as jseg
from kissmpc_tpu.perception import tracker as jt
from kissmpc_tpu_torch import bridge
from kissmpc_tpu_torch.perception import clustering as tc
from kissmpc_tpu_torch.perception import detectors as td
from kissmpc_tpu_torch.perception import pipeline as tp
from kissmpc_tpu_torch.perception import projection as tproj
from kissmpc_tpu_torch.perception import tracker as tt

CPU = "cpu"
POS_TOL = 1e-6  # m
VEL_TOL = 1e-5  # m/s
COUNTERS = ("track_id", "active", "hits", "misses", "age", "next_id")


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small operations, beside other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _assert_tracks(j, t, where=""):
    for name in COUNTERS:
        np.testing.assert_array_equal(_np(getattr(t, name)), _np(getattr(j, name)),
                                      err_msg=f"{name} {where}")
    np.testing.assert_allclose(_np(t.position), _np(j.position), atol=POS_TOL, rtol=0,
                               err_msg=f"position {where}")
    np.testing.assert_allclose(_np(t.velocity), _np(j.velocity), atol=VEL_TOL, rtol=0,
                               err_msg=f"velocity {where}")


def _assert_obstacles(j, t, where=""):
    for name in j._fields:
        np.testing.assert_allclose(_np(getattr(t, name)), _np(getattr(j, name)),
                                   atol=POS_TOL, rtol=0, err_msg=f"{name} {where}")


def _clouds(rng, B, P, humans=2):
    """B clouds of P 2-D points: ``humans`` dense blobs (core points), a
    thin ring around each (border points), uniform clutter (noise), and
    ~10% padding."""
    pts = rng.uniform(-2.0, 2.0, (B, P, 2))
    per = P // (2 * humans)
    for h in range(humans):
        centre = rng.uniform(-1.5, 1.5, (B, 1, 2))
        lo = h * per
        pts[:, lo:lo + per - 3] = centre + rng.normal(0, 0.02, (B, per - 3, 2))
        ang = rng.uniform(0, 2 * np.pi, (B, 3))
        ring = np.stack([np.cos(ang), np.sin(ang)], -1) * rng.uniform(0.07, 0.12, (B, 3, 1))
        pts[:, lo + per - 3:lo + per] = centre + ring
    mask = rng.uniform(size=(B, P)) < 0.9
    return pts.astype(np.float32), mask


# --- projection ---------------------------------------------------------------


def test_se3_from_quaternion_apply_inverse_compose():
    rng = np.random.default_rng(1)
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    t = rng.normal(size=3)
    pts = rng.normal(size=(2, 10, 3))
    j = jproj.SE3.from_quaternion(t, q)
    p = tproj.SE3.from_quaternion(t, q)
    np.testing.assert_allclose(p.rotation.numpy(), np.asarray(j.rotation), atol=1e-6, rtol=0)
    np.testing.assert_allclose(p.apply(torch.tensor(pts)).numpy(), np.asarray(j.apply(pts)),
                               atol=1e-6, rtol=0)
    np.testing.assert_allclose(p.inverse().apply(p.apply(torch.tensor(pts))).numpy(), pts,
                               atol=1e-6, rtol=0)
    q2 = rng.normal(size=4)
    q2 /= np.linalg.norm(q2)
    j2, p2 = jproj.SE3.from_quaternion(-t, q2), tproj.SE3.from_quaternion(-t, q2)
    for a, b in zip(p.compose(p2), j.compose(j2)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-6, rtol=0)
    # float32 points through a float32 transform stay float32, as in the reference.
    p32 = tproj.SE3(p.rotation.float(), p.translation.float())
    assert p32.apply(torch.tensor(pts, dtype=torch.float32)).dtype == torch.float32


@pytest.mark.parametrize("intr_dtype", [np.float32, np.float64])
def test_range_filter_and_projection_masks_exact(intr_dtype):
    """Points inside and beyond 5 m, behind the camera, off the image and
    on it, in float32 through float32 or float64 intrinsics (a recorded
    session's are float64)."""
    rng = np.random.default_rng(2)
    B, P, W, H = 4, 256, 64, 48
    pts = np.concatenate([rng.uniform(-3, 3, (B, P, 2)), rng.uniform(-1, 6, (B, P, 1))], -1)
    pts = pts.astype(np.float32)
    mask = rng.uniform(size=(B, P)) < 0.8
    intr = [intr_dtype(v) for v in (40.0, 38.0, W / 2, H / 2)]
    j_intr, t_intr = jproj.Intrinsics(*map(jnp.asarray, intr)), tproj.Intrinsics(
        *map(torch.tensor, intr))
    j_range = jax.vmap(lambda p, m: jproj.range_filter(p, m, 5.0))(pts, mask)
    t_range = tproj.range_filter(torch.tensor(pts), torch.tensor(mask), 5.0)
    np.testing.assert_array_equal(t_range.numpy(), np.asarray(j_range))
    assert 0 < t_range.sum() < mask.sum()
    j_uv, j_valid = jax.vmap(lambda p, m: jproj.project_points(j_intr, p, m, W, H))(pts, mask)
    t_uv, t_valid = tproj.project_points(t_intr, torch.tensor(pts), torch.tensor(mask), W, H)
    np.testing.assert_array_equal(t_valid.numpy(), np.asarray(j_valid))
    np.testing.assert_array_equal(t_uv.numpy(), np.asarray(j_uv))
    assert t_uv.dtype == torch.int32 and 0 < t_valid.sum() < mask.sum()

    # points_in_mask: a batched gather over [B, M, H, W] instance masks.
    M = 3
    seg = rng.uniform(size=(B, M, H, W)) < 0.3
    j_hit = jax.vmap(jax.vmap(jproj.points_in_mask, in_axes=(0, None, None)))(
        seg, j_uv, j_valid)
    t_hit = tproj.points_in_mask(torch.tensor(seg), t_uv[:, None], t_valid[:, None])
    np.testing.assert_array_equal(t_hit.numpy(), np.asarray(j_hit))
    assert t_hit.shape == (B, M, P) and 0 < t_hit.sum()


# --- clustering ---------------------------------------------------------------


@pytest.mark.parametrize("P", [64, 128])
def test_dbscan_labels_and_cluster_means_match_jax(P):
    rng = np.random.default_rng(P)
    B = 8
    pts, mask = _clouds(rng, B, P)
    jres = jax.jit(jax.vmap(lambda p, m: jc.dbscan(p, m, 0.08, 10)))(pts, mask)
    tres = tc.dbscan(torch.tensor(pts), torch.tensor(mask), 0.08, 10)
    labels = np.asarray(jres.labels)
    np.testing.assert_array_equal(tres.labels.numpy(), labels)
    np.testing.assert_array_equal(tres.num_clusters.numpy(), np.asarray(jres.num_clusters))
    assert tres.labels.dtype == torch.int32
    # The clouds exercise every kind of point: cores in clusters, border
    # points (labelled but not core), noise.
    d2 = ((pts[:, :, None] - pts[:, None]) ** 2).sum(-1)
    core = mask & (((d2 <= 0.08 ** 2) & mask[:, None] & mask[:, :, None]).sum(-1) >= 10)
    assert (labels == -1).any() and ((labels >= 0) & ~core).any()
    assert (np.asarray(jres.num_clusters) >= 2).all()
    jc_, jf = jax.jit(jax.vmap(jc.largest_cluster_mean))(pts, jres)
    tc_, tf = tc.largest_cluster_mean(torch.tensor(pts), tres)
    np.testing.assert_array_equal(tf.numpy(), np.asarray(jf))
    np.testing.assert_allclose(tc_.numpy(), np.asarray(jc_), atol=POS_TOL, rtol=0)


def test_dbscan_unbatched_and_empty_cluster():
    """One cloud with no leading axis; one with every point padded (no
    cluster: centre zeros, found False)."""
    rng = np.random.default_rng(5)
    pts, mask = _clouds(rng, 1, 64)
    for m in (mask[0], np.zeros_like(mask[0])):
        j = jc.dbscan(jnp.asarray(pts[0]), jnp.asarray(m), 0.08, 10)
        t = tc.dbscan(torch.tensor(pts[0]), torch.tensor(m), 0.08, 10)
        np.testing.assert_array_equal(t.labels.numpy(), np.asarray(j.labels))
        assert int(t.num_clusters) == int(j.num_clusters)
        jcen, jf = jc.largest_cluster_mean(jnp.asarray(pts[0]), j)
        tcen, tf = tc.largest_cluster_mean(torch.tensor(pts[0]), t)
        assert bool(tf) == bool(jf)
        np.testing.assert_allclose(tcen.numpy(), np.asarray(jcen), atol=POS_TOL, rtol=0)


# --- tracker ------------------------------------------------------------------


def _detections(rng, frames, B, D):
    """Detections of a few walkers with jitter, dropped detections (misses)
    and spurious ones (spawns that later retire)."""
    start = rng.uniform(-2, 2, (B, D, 2))
    vel = rng.uniform(-1, 1, (B, D, 2))
    out = []
    for f in range(frames):
        det = start + vel * 0.1 * f + rng.normal(0, 0.02, (B, D, 2))
        valid = rng.uniform(size=(B, D)) < 0.75
        spurious = rng.uniform(size=(B, D)) < 0.1
        det = np.where(spurious[..., None], rng.uniform(-3, 3, (B, D, 2)), det)
        out.append((det.astype(np.float32), valid))
    return out


def test_tracker_update_matches_jax_over_20_frames():
    rng = np.random.default_rng(7)
    B, T, D, dt = 6, 4, 3, 0.1
    jcfg, tcfg = jt.TrackerConfig(max_misses=2), tt.TrackerConfig(max_misses=2)
    jstate = jax.vmap(lambda _: jt.init_tracks(T, jnp.float32))(jnp.arange(B))
    tstate = tt.init_tracks(T, torch.float32, batch=B, device=CPU)
    jupdate = jax.jit(jax.vmap(lambda s, d, m: jt.update(jcfg, s, d, m, dt)))
    retired = spawned_late = 0
    for f, (det, valid) in enumerate(_detections(rng, 20, B, D)):
        before = np.asarray(jstate.active)
        jstate = jupdate(jstate, det, valid)
        tstate = tt.update(tcfg, tstate, torch.tensor(det), torch.tensor(valid), dt)
        _assert_tracks(jstate, tstate, f"frame {f}")
        after = np.asarray(jstate.active)
        retired += int((before & ~after).sum())
        spawned_late += int((~before & after).sum()) if f > 0 else 0
        jo = jax.vmap(lambda s: jt.to_obstacles(jcfg, s))(jstate)
        _assert_obstacles(jo, tt.to_obstacles(tcfg, tstate), f"frame {f}")
    assert retired > 0 and spawned_late > 0
    assert (np.asarray(jstate.next_id) > T).all()


def test_tracker_unbatched_and_bridged_state():
    """A table without a batch axis, started from a JAX table carried over
    by `bridge.perception_state_from_numpy`, with more detections than
    slots."""
    rng = np.random.default_rng(8)
    T, D, dt = 3, 5, 0.1
    cfg = jt.TrackerConfig()
    frames = _detections(rng, 8, 1, D)
    jstate = jt.init_tracks(T, jnp.float32)
    for det, valid in frames[:4]:
        jstate = jt.update(cfg, jstate, jnp.asarray(det[0]), jnp.asarray(valid[0]), dt)
    tstate = bridge.perception_state_from_numpy(jp.PerceptionState(tracks=jstate),
                                                device=CPU).tracks
    _assert_tracks(jstate, tstate)
    for f, (det, valid) in enumerate(frames[4:]):
        jstate = jt.update(cfg, jstate, jnp.asarray(det[0]), jnp.asarray(valid[0]), dt)
        tstate = tt.update(tt.TrackerConfig(), tstate, torch.tensor(det[0]),
                           torch.tensor(valid[0]), dt)
        _assert_tracks(jstate, tstate, f"frame {f}")
    assert tstate.track_id.shape == (T,) and tstate.next_id.shape == ()


def test_to_obstacles_from_the_same_tracks():
    """Both packages export one track table (confirmed and not, moving and
    at rest, so arctan2(0, 0) appears) within 1e-6."""
    rng = np.random.default_rng(9)
    T = 6
    vel = rng.normal(size=(T, 2)).astype(np.float32)
    vel[:2] = 0.0
    table = jt.TrackTable(
        position=rng.normal(size=(T, 2)).astype(np.float32), velocity=vel,
        age=np.arange(T, dtype=np.int32), misses=np.zeros(T, np.int32),
        hits=np.array([0, 3, 1, 2, 5, 2], np.int32),
        active=np.array([True, True, False, True, True, True]),
        next_id=np.int32(T), track_id=np.arange(T, dtype=np.int32))
    j = jt.to_obstacles(jt.TrackerConfig(), jax.tree.map(jnp.asarray, table))
    t = tt.to_obstacles(tt.TrackerConfig(),
                        bridge.perception_state_from_numpy(table, device=CPU).tracks)
    _assert_obstacles(j, t)
    assert float(t.active.sum()) == 4


# --- pipeline -----------------------------------------------------------------


def test_pipeline_step_over_the_walk_matches_jax_vmap(tmp_path):
    """B=4 pipelines fed one recorded frame per tick, as the fleet bench
    feeds them (`scripts/bench_perception_tick.py:91-98`)."""
    path = str(tmp_path / "walk.npz")
    truth = j_record_walk(path, n_frames=14, dt=0.1)
    frames = list(JReplayer(path).synced())
    B, cap = 4, 3
    jcfg, tcfg = jt.TrackerConfig(), tt.TrackerConfig()
    geom = frames[0].geometry
    tgeom = bridge.geometry_from_numpy(geom, device=CPU)
    jstate = jax.vmap(lambda _: jp.init_perception(cap, jnp.float32))(jnp.arange(B))
    tstate = tp.init_perception(cap, torch.float32, batch=B, device=CPU)

    @jax.jit
    def jstep(state, pts, pm, im, iv):
        return jax.vmap(lambda s: jp.step(jcfg, s, geom, pts, pm, im, iv, dt=0.1))(state)

    for f, fr in enumerate(frames):
        jstate, jobs = jstep(jstate, fr.points, fr.point_mask, fr.instance_masks,
                             fr.instance_valid)
        tstate, tobs = tp.step(tcfg, tstate, tgeom, torch.tensor(fr.points),
                               torch.tensor(fr.point_mask), torch.tensor(fr.instance_masks),
                               torch.tensor(fr.instance_valid), 0.1, device=CPU)
        _assert_tracks(jstate.tracks, tstate.tracks, f"frame {f}")
        _assert_obstacles(jobs, tobs, f"frame {f}")
    # Every pipeline tracks the walker near the ground truth.
    active = tobs.active.numpy() > 0
    assert active.sum() == B
    err = np.abs(tobs.position.numpy()[active] - truth[-1]).max()
    assert err < 0.25, err


def test_detect_centers_two_instances_match_jax():
    """Two humans, two instance masks plus a padded slot, a float64
    transform to the map frame."""
    rng = np.random.default_rng(11)
    H, W, P, M = 48, 64, 128, 3
    pts = np.zeros((P, 3), np.float32)
    for h, x in enumerate((-0.4, 0.5)):
        pts[h * 40:(h + 1) * 40, :2] = np.array([x, 0.1]) + rng.normal(0, 0.02, (40, 2))
        pts[h * 40:(h + 1) * 40, 2] = 2.0
    pts[80:] = rng.uniform(-3, 3, (P - 80, 3))
    pmask = np.ones(P, bool)
    seg = np.zeros((M, H, W), bool)
    seg[0, :, :32] = True
    seg[1, :, 32:] = True
    valid = np.array([True, True, False])
    intr = [np.float32(v) for v in (40.0, 40.0, W / 2, H / 2)]
    eye = (np.eye(3, dtype=np.float32), np.zeros(3, np.float32))
    to_map = (jnp.asarray(jproj.SE3.from_quaternion([1.0, 2.0, 0.0], [0, 0, 0.6, 0.8])[0]),
              np.array([1.0, 2.0, 0.0]))
    jgeom = jp.FrameGeometry(jproj.Intrinsics(*intr), jproj.SE3(*eye), jproj.SE3(*to_map), W, H)
    jcen, jfound = jp.detect_centers(jgeom, pts, pmask, seg, valid)
    tcen, tfound = tp.detect_centers(bridge.geometry_from_numpy(jgeom, device=CPU),
                                     torch.tensor(pts), torch.tensor(pmask),
                                     torch.tensor(seg), torch.tensor(valid), device=CPU)
    np.testing.assert_array_equal(tfound.numpy(), np.asarray(jfound))
    assert tfound.numpy().tolist() == [True, True, False]
    np.testing.assert_allclose(tcen.numpy(), np.asarray(jcen), atol=POS_TOL, rtol=0)


# --- detectors ----------------------------------------------------------------


def _blob_image(rng, H=40, W=56):
    img = rng.uniform(0.0, 0.3, (H, W))
    img[5:15, 6:20] = 0.9
    img[22:34, 30:44] = 0.8
    img[30:33, 2:4] = 0.95  # too small for min_area
    return img


def test_threshold_blob_detector_and_render_match():
    rng = np.random.default_rng(12)
    img = _blob_image(rng)
    j = jd.ThresholdBlobDetector(max_instances=3)(img)
    t = td.ThresholdBlobDetector(max_instances=3)(img)
    for a, b in zip(t, j):
        np.testing.assert_array_equal(a, b)
    assert t.valid.sum() == 2
    for image in (img, (img * 255).astype(np.uint8)):
        ja, js = jd.render_annotated(image, j)
        ta, ts = td.render_annotated(image, t)
        np.testing.assert_array_equal(ta, ja)
        np.testing.assert_array_equal(ts, js)


def test_segnet_brightness_and_adapter_match():
    """The port's TinySegNet holding the JAX package's copy's weights
    (`bridge.segnet_from_numpy`), and `brightness()` built in code by both,
    segment the same instances; the adapters agree."""
    rng = np.random.default_rng(13)
    img = np.repeat(_blob_image(rng)[..., None], 3, axis=-1).astype(np.float32)
    jnet = jseg.TinySegNet.brightness(max_instances=3)
    weights = {k: v.numpy() for k, v in jnet.state_dict().items()}
    tnet = bridge.segnet_from_numpy(weights, device=CPU, max_instances=3)
    from kissmpc_tpu_torch.perception.segnet import TinySegNet

    built = TinySegNet.brightness(max_instances=3, device=CPU)
    x = torch.tensor(np.moveaxis(img, -1, 0))
    with torch.no_grad():
        ref = jnet(x)
        for net in (tnet, built):
            out = net(x)
            np.testing.assert_array_equal(out["masks"].numpy(), ref["masks"].numpy())
            np.testing.assert_array_equal(out["scores"].numpy(), ref["scores"].numpy())
    jdet = jd.TorchSegmentationAdapter(jnet, max_instances=3)(img)
    tdet = td.TorchSegmentationAdapter(tnet, max_instances=3, device=CPU)(img)
    for a, b in zip(tdet, jdet):
        np.testing.assert_array_equal(a, b)
    assert tdet.valid.sum() == 2
