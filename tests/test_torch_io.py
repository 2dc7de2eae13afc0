"""Port parity of the I/O layer: `kissmpc_tpu_torch.io` on the CPU against
`kissmpc_tpu.io` (JAX on the CPU), on inputs made from a numpy seed.

Tolerances: `approx_sync` pairs, recorded and replayed frames, the
synthetic walk's recording, `transforms` and `markers` exactly equal;
`replay_session` per-frame obstacles within 1e-6; the `ScenarioRecorder`
round trip exact (a re-solve on the CPU reproduces the recorded controls
bit for bit); `Model` commands within 1e-4 over 5 ticks at N=7 (the node's
defaults); `Ros2Interface` against a fake rclpy tree of this file's own:
the same topics, and the same commands as the JAX adapter within 1e-4.
"""

import sys
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kissmpc_tpu.io import frames as jframes
from kissmpc_tpu.io import markers as jmarkers
from kissmpc_tpu.io import model as jmodel
from kissmpc_tpu.io import ros2 as jros2
from kissmpc_tpu.io import transforms as jtf
from kissmpc_tpu.perception import tracker as jt
from kissmpc_tpu_torch import MPCConfig, default_problem, make_solver
from kissmpc_tpu_torch.io import frames as tframes
from kissmpc_tpu_torch.io import markers as tmarkers
from kissmpc_tpu_torch.io import model as tmodel
from kissmpc_tpu_torch.io import pubsub, replay
from kissmpc_tpu_torch.io import ros2 as tros2
from kissmpc_tpu_torch.io import transforms as ttf
from kissmpc_tpu_torch.perception import tracker as tt
from kissmpc_tpu_torch.perception.pipeline import FrameGeometry
from kissmpc_tpu_torch.perception.projection import SE3, Intrinsics

CPU = "cpu"
OBS_TOL = 1e-6
CMD_TOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: many small operations, beside other workers."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


# --- transforms and markers -----------------------------------------------------


def test_transforms_match():
    rng = np.random.default_rng(0)
    for _ in range(5):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        assert ttf.yaw_from_quaternion(q) == jtf.yaw_from_quaternion(q)
        yaw = rng.uniform(-3, 3)
        np.testing.assert_array_equal(ttf.quaternion_from_yaw(yaw), jtf.quaternion_from_yaw(yaw))
    x, y, th = rng.normal(size=3)
    a, b = ttf.SE2(x, y, th), jtf.SE2(x, y, th)
    pts = rng.normal(size=(6, 2))
    np.testing.assert_array_equal(a.apply(pts), b.apply(pts))
    np.testing.assert_array_equal(a.apply_pose([0.3, 0.4, 0.5]), b.apply_pose([0.3, 0.4, 0.5]))
    np.testing.assert_array_equal(a.inverse().apply(pts), b.inverse().apply(pts))
    np.testing.assert_array_equal(a.compose(a.inverse()).apply(pts),
                                  b.compose(b.inverse()).apply(pts))
    tq, jq = (m.SE2.from_translation_quaternion([1.0, 2.0, 0.0], q) for m in (ttf, jtf))
    np.testing.assert_array_equal(tq.rotation, jq.rotation)
    poses = np.stack([np.arange(60.0), rng.normal(size=60), rng.normal(size=60)], axis=1)
    for stride in (1, 7, 25, 100):
        np.testing.assert_array_equal(ttf.decimate_plan(poses, stride),
                                      jtf.decimate_plan(poses, stride))
    wps = np.array([[0.0, 0.0, 0.0], [1.0, 1.0, 0.0]])
    for final in ([1.0, 1.05, 0.0], [1.5, 1.0, 0.0]):
        assert ttf.plan_changed(wps, final) == jtf.plan_changed(wps, final)
    assert ttf.plan_changed(None, [0, 0, 0]) and ttf.plan_changed(np.zeros((0, 3)), [0, 0, 0])


def test_markers_match():
    rng = np.random.default_rng(1)
    states = rng.normal(size=(8, 3))
    for layout in (states, states.T):
        assert tmarkers.future_states_markers(layout) == jmarkers.future_states_markers(layout)
    tpub, jpub = tmarkers.TrackMarkerPublisher(), jmarkers.TrackMarkerPublisher()
    for ids, active in (([7, 9, -1], None), ([7, 9], [True, False]), ([7], None), ([], None)):
        pos = rng.normal(size=(len(ids), 2))
        got, ref = tpub.update(ids, pos, active), jpub.update(ids, pos, active)
        assert got == ref
    tpub.update([3], np.zeros((1, 2)))
    gone = tpub.update([], np.zeros((0, 2)))
    assert [(m["id"], m["action"]) for m in gone] == [(3, tmarkers.DELETE)]


# --- frames -------------------------------------------------------------------------


def test_approx_sync_matches():
    rng = np.random.default_rng(2)
    for n_a, n_b, slop in ((12, 10, 0.05), (20, 25, 0.1), (5, 0, 0.1), (8, 8, 0.0)):
        ts_a = np.sort(rng.uniform(0, 2, n_a))
        ts_b = np.sort(rng.uniform(0, 2, n_b))
        assert tframes.approx_sync(ts_a, ts_b, slop) == jframes.approx_sync(ts_a, ts_b, slop)


def _record_session(module, path, rng_seed=3, n_frames=8, jitter=0.008):
    """One session, recorded by ``module``'s FrameRecorder from the same
    numpy arrays: a human walking +x at 1 m/s, 2 m ahead, a second instance
    slot padded, and a per-frame lidar->map transform."""
    H, W, P = 48, 64, 128
    if module is jframes:
        from kissmpc_tpu.perception import SE3 as S, FrameGeometry as G, Intrinsics as I
    else:
        S, G, I = SE3, FrameGeometry, Intrinsics
    eye = S(rotation=np.eye(3), translation=np.zeros(3))
    geom = G(intrinsics=I(np.float32(40.0), np.float32(40.0), np.float32(W / 2),
                          np.float32(H / 2)),
             lidar_to_camera=eye, lidar_to_map=eye, image_width=W, image_height=H)
    rec = module.FrameRecorder(geom)
    rng = np.random.default_rng(rng_seed)
    for k in range(n_frames):
        t = 0.1 * k
        pts = np.zeros((P, 3), np.float32)
        pts[:40, 0] = 0.1 * k + rng.normal(0, 0.02, 40)
        pts[:40, 1] = rng.normal(0, 0.02, 40)
        pts[:40, 2] = 2.0
        mask = np.zeros(P, bool)
        mask[:40] = True
        seg = np.zeros((2, H, W), bool)
        seg[0] = True
        to_map = S(rotation=np.eye(3, dtype=np.float32),
                   translation=np.array([0.5, -0.2 * k, 0.0], np.float32))
        rec.record_cloud(t + rng.uniform(-jitter, jitter), pts, mask,
                         to_map if k % 2 else None)
        rec.record_image(t + rng.uniform(-jitter, jitter), seg, np.array([True, False]))
    assert len(rec) == 2 * n_frames
    rec.save(path)
    return path


def _geometry_leaves(geom):
    """The leaves of a FrameGeometry of either package, as numpy arrays."""
    return [np.asarray(x) for part in geom[:3] for x in part] + [geom.image_width,
                                                                geom.image_height]


def test_frame_record_and_replay_match(tmp_path):
    tpath = _record_session(tframes, str(tmp_path / "t.npz"))
    jpath = _record_session(jframes, str(tmp_path / "j.npz"))
    a, b = np.load(tpath), np.load(jpath)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k
    for slop in (0.05, 0.1):
        got = list(tframes.FrameReplayer(tpath).synced(slop=slop))
        ref = list(jframes.FrameReplayer(jpath).synced(slop=slop))
        assert len(got) == len(ref) > 0
        for g, r in zip(got, ref):
            assert g.stamp == r.stamp
            for name in ("points", "point_mask", "instance_masks", "instance_valid"):
                np.testing.assert_array_equal(getattr(g, name), getattr(r, name))
            for x, y in zip(_geometry_leaves(g.geometry), _geometry_leaves(r.geometry)):
                np.testing.assert_array_equal(x, y)
    # Pacing sleeps out the recorded gaps, scaled by the rate.
    sleeps = []
    frames = list(tframes.FrameReplayer(tpath).synced(slop=0.05, pace=True, rate=2.0,
                                                       sleep=sleeps.append))
    gaps = np.diff([f.stamp for f in frames]) / 2.0
    np.testing.assert_allclose(sleeps, gaps[gaps > 0], rtol=0, atol=1e-12)


def test_synthetic_walk_recording_matches(tmp_path):
    tpath, jpath = str(tmp_path / "t.npz"), str(tmp_path / "j.npz")
    t_truth = tframes.record_synthetic_walk(tpath, n_frames=9, dt=0.1, seed=4)
    j_truth = jframes.record_synthetic_walk(jpath, n_frames=9, dt=0.1, seed=4)
    np.testing.assert_array_equal(t_truth, j_truth)
    a, b = np.load(tpath), np.load(jpath)
    assert sorted(a.files) == sorted(b.files)
    for k in a.files:
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        assert a[k].dtype == b[k].dtype, k


@pytest.mark.parametrize("walk", [False, True])
def test_replay_session_matches_jax(tmp_path, walk):
    """The recorded session (with per-frame lidar->map transforms and
    jittered stamps) and the synthetic walk, through each package's
    `replay_session`: every frame's obstacles within 1e-6."""
    path = str(tmp_path / "s.npz")
    if walk:
        jframes.record_synthetic_walk(path, n_frames=6, dt=0.1)
        jcfg, tcfg = jt.TrackerConfig(), tt.TrackerConfig()
    else:
        _record_session(jframes, path, n_frames=6)
        jcfg, tcfg = jt.TrackerConfig(min_hits=1), tt.TrackerConfig(min_hits=1)
    jstate, jobs = jframes.replay_session(jframes.FrameReplayer(path), jcfg, capacity=4)
    tstate, tobs = tframes.replay_session(tframes.FrameReplayer(path), tcfg, capacity=4,
                                          device=CPU)
    assert len(tobs) == len(jobs) > 0
    for f, (j, t) in enumerate(zip(jobs, tobs)):
        for name in j._fields:
            np.testing.assert_allclose(getattr(t, name).numpy(), np.asarray(getattr(j, name)),
                                       atol=OBS_TOL, rtol=0, err_msg=f"{name} frame {f}")
    np.testing.assert_array_equal(tstate.tracks.track_id.numpy(),
                                  np.asarray(jstate.tracks.track_id))
    assert float(tobs[-1].active.sum()) >= 1.0


# --- scenario recording ---------------------------------------------------------------


def test_scenario_record_replay_round_trip(tmp_path):
    cfg = MPCConfig(horizon=8, time_step=0.1)
    solver = make_solver(cfg, device=CPU)
    rec = replay.ScenarioRecorder()
    problems, solutions = [], []
    for i in range(4):
        p = default_problem(cfg, [0.0, 0.0, 0.0], [1.0, 0.1 * i, 0.0], dtype=torch.float64,
                            device=CPU)
        sol = solver(p)
        rec.record(p, sol)
        problems.append(p)
        solutions.append(sol)
    path = str(tmp_path / "session.npz")
    rec.save(path)
    rep = replay.ScenarioReplayer(path)
    assert rep.num_ticks == 4
    for i, tick in enumerate(rep):
        for name, x in problems[i]._asdict().items():
            np.testing.assert_array_equal(getattr(tick.problem, name), x.numpy(), err_msg=name)
        np.testing.assert_array_equal(tick.solution.controls, solutions[i].controls.numpy())
        for a, b in zip(tick.solution.diagnostics, solutions[i].diagnostics):
            np.testing.assert_array_equal(a, b.numpy())
    assert rep.verify(solver, atol=0.0) == 0.0
    rep._solutions = rep._solutions._replace(controls=rep._solutions.controls + 1e-3)
    with pytest.raises(AssertionError):
        rep.verify(solver, atol=1e-6)
    with pytest.raises(ValueError):
        replay.ScenarioRecorder().save(str(tmp_path / "empty.npz"))


# --- pub-sub ----------------------------------------------------------------------------


def test_latest_value_rate_timer_and_native_slot():
    slot = pubsub.LatestValue()
    assert slot.read() == (None, 0)
    slot.publish("a")
    slot.publish("b")
    assert slot.read() == ("b", 2)
    timer = pubsub.RateTimer(0.001)
    assert timer.sleep() in (0, 1)
    native = pubsub.NativeLatestValue.create((2, 3))
    if native is None:
        pytest.skip("g++ is not available to build the port's native library")
    try:
        assert native.read() == (None, 0)
        payload = np.arange(6.0).reshape(2, 3)
        native.publish(payload)
        native.publish(payload + 1)
        value, version = native.read()
        np.testing.assert_array_equal(value, payload + 1)
        assert version > 0
    finally:
        native.close()


# --- Model ---------------------------------------------------------------------------------

NODE = dict(initial_position=(0.0, 0.0), initial_orientation=0.4, horizon=7,
            planning_time_step=0.8, linear_velocity_bounds=(-0.3, 0.3),
            angular_velocity_bounds=(-0.3, 0.3),
            waypoints=[[1.0, 0.6, 0.0], [2.2, 1.0, 0.3]])


def _obstacles(module):
    centers, radii = np.array([[0.8, 0.2], [1.5, 1.4], [9.0, 9.0]]), np.array([0.2, 0.3, 0.4])
    if module is jmodel:
        from kissmpc_tpu.obstacles import dynamic_set

        return dynamic_set(jnp.asarray(centers), jnp.asarray(radii), jnp.array([0.5, 0.0, 0.0]),
                           jnp.array([0.2, 0.0, 0.0]), max_obstacles=4, dtype=jnp.float32)
    from kissmpc_tpu_torch.obstacles import dynamic_set

    return dynamic_set(centers, radii, [0.5, 0.0, 0.0], [0.2, 0.0, 0.0], max_obstacles=4,
                       dtype=torch.float32, device=CPU)


@pytest.mark.parametrize("K", [0, 4])
def test_model_five_ticks_match_jax(K):
    """The node's defaults (N=7, planning dt 0.8, 40 iterations), free and
    with 4 obstacle slots from `set_obstacles`; the odometry override on the
    last tick."""
    j = jmodel.Model(max_obstacles=K, **NODE)
    t = tmodel.Model(max_obstacles=K, device=CPU, **NODE)
    if K:
        j.set_obstacles(_obstacles(jmodel))
        t.set_obstacles(_obstacles(tmodel))
    assert t.states_matrix.shape == (3, 8) and t.controls_matrix.shape == (2, 7)
    for tick in range(5):
        if tick == 4:
            for m in (j, t):
                m.initial_state = np.array([0.1, 0.05, 0.45])
                m.reset(matrices_only=True)
        j.step(state_override=tick == 4)
        t.step(state_override=tick == 4)
        assert isinstance(t.linear_velocity, float)
        assert abs(t.linear_velocity - j.linear_velocity) <= CMD_TOL, tick
        assert abs(t.angular_velocity - j.angular_velocity) <= CMD_TOL, tick
        np.testing.assert_allclose(t.states_matrix, j.states_matrix, atol=CMD_TOL, rtol=0)
        assert bool(t.last_diagnostics.converged) == bool(j.last_diagnostics.converged)
        assert t.waypoint_index == j.waypoint_index
    if not K:
        assert t.linear_velocity > 0.05


def test_model_waypoint_advance_and_control_loop():
    """`ControlLoop` folds odometry and a plan into the port's `Model` and
    advances its waypoints, as the JAX loop does with the JAX `Model`."""
    def run(module, loop_mod, **device):
        model = module.Model(initial_position=(0.0, 0.0), initial_orientation=0.0, horizon=8,
                             planning_time_step=0.2, linear_velocity_bounds=(-0.2, 0.5),
                             angular_velocity_bounds=(-0.5, 0.5), **device)
        odom, plan, commands = loop_mod.LatestValue(), loop_mod.LatestValue(), []
        loop = loop_mod.ControlLoop(model, odometry=odom, plan=plan,
                                    on_command=lambda v, w: commands.append((v, w)))
        assert not loop.tick() and commands == []
        plan.publish(np.array([[0.3, 0.0, 0.0], [1.0, 0.2, 0.0]]))
        odom.publish(np.array([0.0, 0.0, 0.0]))
        for _ in range(6):
            assert loop.tick()
        return model, np.array(commands)

    from kissmpc_tpu.io import pubsub as jpubsub

    jm, jc = run(jmodel, jpubsub)
    tm, tc = run(tmodel, pubsub, device=CPU)
    np.testing.assert_allclose(tc, jc, atol=CMD_TOL, rtol=0)
    assert tm.waypoint_index == jm.waypoint_index == 1
    np.testing.assert_array_equal(tm.goal_state, [1.0, 0.2, 0.0])


# --- ROS 2 adapter against a fake rclpy ---------------------------------------------------


class _Msg:
    """An attribute tree: any attribute read that was not set is a child."""

    def __init__(self, **values):
        self.__dict__.update(values)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        child = _Msg()
        setattr(self, name, child)
        return child


def _pose(x=0.0, y=0.0, yaw=0.0):
    return _Msg(position=_Msg(x=x, y=y, z=0.0),
                orientation=_Msg(x=0.0, y=0.0, z=np.sin(yaw / 2), w=np.cos(yaw / 2)))


class _Node:
    def __init__(self, name):
        self.name, self.subs, self.pubs, self.timers = name, {}, {}, []

    def create_subscription(self, msg_type, topic, callback, depth):
        self.subs[topic] = callback

    def create_publisher(self, msg_type, topic, depth):
        pub = _Msg(published=[])
        pub.publish = pub.published.append
        self.pubs[topic] = pub
        return pub

    def create_timer(self, period, callback):
        self.timers.append((period, callback))


@pytest.fixture
def fake_rclpy(monkeypatch):
    msgs = {"geometry_msgs": dict(Twist=_Msg), "nav_msgs": dict(Odometry=_Msg, Path=_Msg),
            "visualization_msgs": dict(Marker=_Msg, MarkerArray=_Msg)}
    for pkg, types_ in msgs.items():
        mod = types.ModuleType(pkg)
        mod.msg = types.SimpleNamespace(**types_)
        monkeypatch.setitem(sys.modules, pkg, mod)
        monkeypatch.setitem(sys.modules, pkg + ".msg", mod.msg)
    return types.SimpleNamespace(create_node=_Node, spin=lambda node: None)


def test_ros2_interface_against_fake_rclpy(fake_rclpy):
    assert not tros2.ros2_available()
    odom = _Msg(pose=_Msg(pose=_pose(0.0, 0.0, 0.1)))
    path = _Msg(poses=[_Msg(pose=_pose(0.1 * i, 0.02 * i)) for i in range(7)])
    model_kw = dict(horizon=6, planning_time_step=0.2, linear_velocity_bounds=(-0.3, 0.3),
                    angular_velocity_bounds=(-0.3, 0.3))
    out = {}
    for name, mod, kw in (("jax", jros2, {}), ("port", tros2, {"device": CPU})):
        iface = mod.Ros2Interface(mod.Model(**model_kw, **kw), rclpy_module=fake_rclpy,
                                  plan_stride=2)
        node = iface.node
        assert set(node.subs) == {"/plan", "/odom"}
        assert set(node.pubs) == {"cmd_vel", "/future_states"}
        assert len(node.timers) == 1 and node.timers[0][0] == pytest.approx(0.01)
        node.timers[0][1]()
        assert node.pubs["cmd_vel"].published == []
        node.subs["/odom"](odom)
        node.subs["/plan"](path)
        for _ in range(3):
            node.timers[0][1]()
        cmds = node.pubs["cmd_vel"].published
        markers = node.pubs["/future_states"].published
        assert len(cmds) == 3 and len(markers) == 3 and len(markers[-1].markers) == 7
        out[name] = np.array([[c.linear.x, c.angular.z] for c in cmds])
    np.testing.assert_allclose(out["port"], out["jax"], atol=CMD_TOL, rtol=0)
    assert 0.0 < out["port"][-1, 0] <= 0.3 + 1e-6
