"""The SORT tracker of the port against the JAX package's, on the CPU: the
JAX package's own tracking cases (stable ids, occlusion within ``max_age``,
death then a new id, the velocity carried through an occlusion, table
overflow, padding rows, the frame loop against single steps), ties in the
IoU matrix, and ``mot_metrics`` on perfect tracking, an id switch, a gap,
false positives and misses. Ids and every count are held exactly equal."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcv_tpu.pipelines import tracking as jt
from deepcv_tpu_torch.pipelines import tracking as tt


def _box(cx, cy, w=10.0, h=10.0):
    return [cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2]


def _clip(frames, visible=None):
    """list of list-of-boxes -> padded (F, D, 4) boxes and (F, D) mask; a
    (F, D) ``visible`` mask hides detections."""
    d = max(len(f) for f in frames)
    boxes = np.zeros((len(frames), d, 4), np.float32)
    mask = np.zeros((len(frames), d), bool)
    for i, f in enumerate(frames):
        for j, b in enumerate(f):
            boxes[i, j] = b
            mask[i, j] = True
    if visible is not None:
        mask &= np.asarray(visible)
    return boxes, mask


def _track_both(boxes, mask, **kw):
    want = np.asarray(jt.track_sequence(jnp.asarray(boxes), jnp.asarray(mask), **kw))
    got = tt.track_sequence(torch.from_numpy(boxes), torch.from_numpy(mask), **kw)
    assert got.dtype == torch.int32 and got.shape == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    return got.numpy()


def _jitter(frames, seed):
    rng = np.random.default_rng(seed)
    return [[[v + rng.normal(0, 0.5) for v in b] for b in f] for f in frames]


def _case(name):
    """(boxes, mask, kwargs) of each case of the JAX package's tests."""
    if name == "parallel":
        return (*_clip([[_box(20 + 2 * t, 20), _box(20 + 2 * t, 60)] for t in range(12)]),
                {"max_tracks": 8})
    if name == "occlusion":
        vis = [[t not in (5, 6)] for t in range(10)]
        return (*_clip([[_box(20 + 2 * t, 30)] for t in range(10)], vis),
                {"max_tracks": 4, "max_age": 3})
    if name == "death":
        vis = [[not 4 <= t < 9] for t in range(14)]
        return *_clip([[_box(30, 30)] for t in range(14)], vis), {"max_tracks": 4, "max_age": 2}
    if name == "velocity":
        vis = [[t not in (5, 6)] for t in range(10)]
        return (*_clip([[_box(10 + 6 * t, 30, 12, 12)] for t in range(10)], vis),
                {"max_tracks": 4, "max_age": 3, "iou_threshold": 0.2})
    if name == "padding":
        boxes, mask = _clip([[_box(20 + 2 * t, 20)] for t in range(6)])
        boxes = np.concatenate([boxes, np.zeros((6, 3, 4), np.float32)], axis=1)
        mask = np.concatenate([mask, np.zeros((6, 3), bool)], axis=1)
        return boxes, mask, {"max_tracks": 4}
    if name == "crossing":
        frames = _jitter([[_box(20 + 2 * t, 20), _box(80 - 3 * t, 60), _box(40, 20 + 4 * t)]
                          for t in range(16)], 3)
        vis = [[t % 5 != 2, t % 7 != 3, True] for t in range(16)]
        return *_clip(frames, vis), {"max_tracks": 8, "max_age": 1}
    if name == "births_beyond_the_table":
        frames = [[_box(20 + 30 * k, 20 + t) for k in range(5)] for t in range(6)]
        vis = [[t % 2 == 0 or k < 2 for k in range(5)] for t in range(6)]
        return *_clip(frames, vis), {"max_tracks": 3, "max_age": 0}
    raise KeyError(name)


CASES = ("parallel", "occlusion", "death", "velocity", "padding", "crossing",
         "births_beyond_the_table")


@pytest.mark.parametrize("name", CASES)
def test_track_sequence_ids_equal_jax(name):
    boxes, mask, kw = _case(name)
    ids = _track_both(boxes, mask, **kw)
    assert (ids[~mask] == -1).all()
    if name in ("parallel", "padding"):
        assert (ids[:, 0] == ids[0, 0]).all() and ids[0, 0] >= 0
    if name == "parallel":
        assert (ids[:, 1] == ids[0, 1]).all() and ids[0, 0] != ids[0, 1]
    if name in ("occlusion", "velocity"):
        assert (ids[mask] == ids[mask][0]).all()
    if name == "death":
        assert ids[13, 0] > ids[0, 0] >= 0


def test_table_overflow_yields_minus_one():
    boxes, mask = _clip([[_box(20, 20), _box(20, 60), _box(20, 100)]])
    _, want = jt.tracker_step(jt.init_tracker(max_tracks=2), jnp.asarray(boxes[0]),
                              jnp.asarray(mask[0]))
    state, got = tt.tracker_step(tt.init_tracker(max_tracks=2), torch.from_numpy(boxes[0]),
                                 torch.from_numpy(mask[0]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got >= 0).sum() == 2 and (got == -1).sum() == 1
    assert state.active.all() and int(state.next_id) == 2


def test_frame_loop_equals_single_steps_and_the_jax_state():
    """``track_sequence`` equals ``tracker_step`` frame by frame, and the
    table after the last step is the JAX one's (means and covariances within
    1e-4 of their scale, the rest equal)."""
    boxes, mask, kw = _case("crossing")
    seq = tt.track_sequence(torch.from_numpy(boxes), torch.from_numpy(mask), **kw)
    t_state, j_state = tt.init_tracker(kw["max_tracks"]), jt.init_tracker(kw["max_tracks"])
    for f in range(len(boxes)):
        t_state, ids = tt.tracker_step(t_state, torch.from_numpy(boxes[f]),
                                       torch.from_numpy(mask[f]), max_age=kw["max_age"])
        j_state, _ = jt.tracker_step(j_state, jnp.asarray(boxes[f]), jnp.asarray(mask[f]),
                                     max_age=kw["max_age"])
        assert torch.equal(ids, seq[f])
    for field in tt.TrackerState._fields:
        got, want = getattr(t_state, field).numpy(), np.asarray(getattr(j_state, field))
        if field in ("mean", "cov"):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4 * np.abs(want).max())
        else:
            np.testing.assert_array_equal(got, want, err_msg=field)


def test_ties_in_the_iou_matrix_resolve_as_jax():
    """Two tracks over one detection at equal IoU, and two detections over
    one track: the first flat index wins in both packages."""
    frames = [[_box(20, 20), _box(30, 20)], [_box(25, 20), _box(200, 200)],
              [_box(25, 20), _box(25, 20)], [_box(25, 20), _box(25, 20)]]
    boxes, mask = _clip(frames)
    ids = _track_both(boxes, mask, max_tracks=4, iou_threshold=0.2)
    assert ids[2, 0] != ids[2, 1]
    from deepcv_tpu_torch.pipelines.tracking import _greedy_match
    iou = torch.tensor([[0.5, 0.5, 0.1], [0.5, 0.5, 0.2]])
    tm, dm = _greedy_match(iou, torch.ones(2, 3, dtype=torch.bool), 0.3)
    j_tm, j_dm = jt._greedy_match(jnp.asarray(iou.numpy()), jnp.ones((2, 3), bool), 0.3)
    assert tm.tolist() == np.asarray(j_tm).tolist() == [0, 1]
    assert dm.tolist() == np.asarray(j_dm).tolist() == [0, 1, -1]


def _metrics_both(gt_boxes, gt_ids, gt_mask, pb, pi, pm, **kw):
    want = jt.mot_metrics(*(jnp.asarray(a) for a in (gt_boxes, gt_ids, gt_mask, pb, pi, pm)),
                          **kw)
    got = tt.mot_metrics(*(torch.from_numpy(np.asarray(a))
                           for a in (gt_boxes, gt_ids, gt_mask, pb, pi, pm)), **kw)
    assert set(got) == set(want)
    for k, v in want.items():
        assert got[k].dtype == (torch.float32 if k == "mota" else torch.int32)
        assert got[k].item() == float(v), k
    return {k: v.item() for k, v in got.items()}


def test_mot_metrics_perfect_tracking():
    boxes, mask = _clip([[_box(20 + 2 * t, 20), _box(20 + 2 * t, 60)] for t in range(8)])
    gt_ids = np.tile(np.array([[3, 7]], np.int32), (8, 1))
    m = _metrics_both(boxes, gt_ids, mask, boxes, gt_ids, mask)
    assert m["mota"] == 1.0 and m["id_switches"] == 0 and m["num_gt"] == m["matches"] == 16


@pytest.mark.parametrize("pred,visible,switches,misses", [
    ([5, 5, 5, 9, 9, 9], None, 1, 0),                           # a switch at frame 3
    ([5] * 6, [True, True, False, False, True, True], 0, 2),    # a gap, the same id
    ([5, 5, 5, 5, 9, 9], [True, True, False, False, True, True], 1, 2)])  # gap, new id
def test_mot_metrics_id_switches_and_gaps(pred, visible, switches, misses):
    boxes, mask = _clip([[_box(20 + 2 * t, 20)] for t in range(6)])
    pm = mask if visible is None else mask & np.asarray(visible)[:, None]
    m = _metrics_both(boxes, np.zeros((6, 1), np.int32), mask, boxes,
                      np.asarray(pred, np.int32)[:, None], pm)
    assert m["id_switches"] == switches and m["misses"] == misses


def test_mot_metrics_false_positives_misses_and_negative_ids():
    """Predictions far from every ground truth are false positives, ground
    truth left unmatched are misses, a prediction with id -1 does not count."""
    gt_boxes, gt_mask = _clip([[_box(20, 20), _box(60, 60)] for _ in range(4)])
    pb, pm = _clip([[_box(20, 20), _box(150, 150), _box(61, 60)] for _ in range(4)])
    pi = np.array([[1, 2, -1]] * 4, np.int32)
    gt_ids = np.array([[0, 1]] * 4, np.int32)
    m = _metrics_both(gt_boxes, gt_ids, gt_mask, pb, pi, pm)
    assert m["false_positives"] == 4 and m["misses"] == 4 and m["matches"] == 4
    m = _metrics_both(gt_boxes, gt_ids, gt_mask, pb, pi, pm, iou_threshold=0.9)
    assert m["matches"] == 4


def test_tracker_and_metrics_on_a_tracked_clip():
    """The tracker's own ids scored against the ground truth of a jittered
    clip with occlusions: every count equal to JAX's."""
    boxes, mask, kw = _case("crossing")
    ids = _track_both(boxes, mask, **kw)
    gt_ids = np.tile(np.arange(3, dtype=np.int32), (len(boxes), 1))
    m = _metrics_both(boxes, gt_ids, mask, boxes, ids, mask)
    assert m["num_gt"] == int(mask.sum()) and m["false_positives"] == 0
