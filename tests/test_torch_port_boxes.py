"""The port's box ops (``deepcv_tpu_torch/ops/boxes.py``) against the JAX
package's on the CPU: IoU, NMS (plain, class-aware with a score
threshold), soft-NMS, mAP, and the top-k that breaks ties by the lower
index, on seeded boxes and scores with deliberate ties."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepcv_tpu.ops import boxes as jb
from deepcv_tpu_torch.ops import boxes as tb

TOL = 1e-6      # the same float32 values, summed or exponentiated otherwise


def _boxes(rng, n, k):
    xy = rng.uniform(0, 1, size=(n, k, 2)).astype(np.float32)
    wh = rng.uniform(0.05, 0.5, size=(n, k, 2)).astype(np.float32)
    return np.concatenate([xy, xy + wh], -1)


def _scores(rng, n, k):
    """Scores with ties: a value repeated three times in every image."""
    s = rng.uniform(size=(n, k)).astype(np.float32)
    s[:, 3] = s[:, 5] = s[:, 11]
    return s


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(0)
    b, s = _boxes(rng, 4, 16), _scores(rng, 4, 16)
    b[0, 7] = b[0, 2]                           # a duplicate box
    b[1, 4, 2:] = b[1, 4, :2]                   # a box of no area
    b[2, 9, 2] = b[2, 9, 0] - 0.1               # an inverted box
    return b, s, rng.integers(0, 3, size=(4, 16))


def test_box_iou_matches_jax_with_degenerate_boxes(data):
    b, _, _ = data
    got = tb.box_iou(torch.from_numpy(b), torch.from_numpy(b)).numpy()
    ref = np.asarray(jb.box_iou(jnp.asarray(b), jnp.asarray(b)))
    assert got.shape == (4, 16, 16) and np.abs(got - ref).max() <= TOL
    assert got[1, 4].max() == 0.0 and got[2, 9].max() == 0.0
    assert got[0, 2, 7] == 1.0


@pytest.mark.parametrize("iou", [0.3, 0.5])
def test_nms_keep_mask_equals_jax(data, iou):
    b, s, _ = data
    got = tb.nms(torch.from_numpy(b), torch.from_numpy(s), iou).numpy()
    ref = np.asarray(jax.vmap(lambda bb, ss: jb.nms(bb, ss, iou))(b, s))
    assert got.dtype == np.bool_ and (got == ref).all() and 0 < got.sum() < got.size


@pytest.mark.parametrize("score_threshold", [None, 0.4])
def test_batched_nms_keep_mask_equals_jax(data, score_threshold):
    """Class-aware, each image's boxes moved by its own span."""
    b, s, c = data
    got = tb.batched_nms(torch.from_numpy(b), torch.from_numpy(s), torch.from_numpy(c), 0.3,
                         score_threshold).numpy()
    ref = np.asarray(jax.vmap(lambda bb, ss, cc: jb.batched_nms(
        bb, ss, cc, 0.3, score_threshold))(b, s, c))
    assert (got == ref).all()
    plain = tb.nms(torch.from_numpy(b), torch.from_numpy(s), 0.3, score_threshold).numpy()
    assert got.sum() > plain.sum()


def test_batched_nms_offsets_by_each_images_span():
    """Two images whose spans differ: a span over the whole batch would move
    the small image's boxes by more than its own and round its IoUs at the
    threshold otherwise; the masks still equal JAX's per-image ones."""
    rng = np.random.default_rng(1)
    b = _boxes(rng, 2, 16)
    b[1] *= 300.0
    s, c = _scores(rng, 2, 16), rng.integers(0, 3, size=(2, 16))
    got = tb.batched_nms(torch.from_numpy(b), torch.from_numpy(s), torch.from_numpy(c),
                         0.5).numpy()
    ref = np.asarray(jax.vmap(lambda bb, ss, cc: jb.batched_nms(bb, ss, cc, 0.5))(b, s, c))
    assert (got == ref).all()


@pytest.mark.parametrize("method", ["gaussian", "linear"])
def test_soft_nms_scores_match_jax(data, method):
    """Linear decays are products the two packages round alike (equal);
    Gaussian ones go through exp, which XLA and torch round a float32 ulp
    apart now and then (within 1e-6)."""
    b, s, _ = data
    got = tb.soft_nms(torch.from_numpy(b), torch.from_numpy(s), method).numpy()
    ref = np.asarray(jax.vmap(lambda bb, ss: jb.soft_nms(bb, ss, method))(b, s))
    assert got.dtype == np.float32
    if method == "linear":
        np.testing.assert_array_equal(got, ref)
    else:
        assert np.abs(got - ref).max() <= TOL
    assert (got <= s + TOL).all() and (got < s - 1e-3).any()
    with pytest.raises(ValueError, match="gaussian"):
        tb.soft_nms(torch.from_numpy(b), torch.from_numpy(s), "hard")


def _map_inputs(seed, absent=None):
    rng = np.random.default_rng(seed)
    n, p, g = 5, 12, 6
    gt = _boxes(rng, n, g)
    gt_cls = rng.integers(0, 4, size=(n, g))
    if absent is not None:
        gt_cls[gt_cls == absent] = (absent + 1) % 4
    gt_valid = rng.uniform(size=(n, g)) > 0.3
    # predictions: jittered copies of the ground truth and random boxes
    pred = np.concatenate([gt + 0.03 * rng.normal(size=gt.shape).astype(np.float32),
                           _boxes(rng, n, p - g)], 1)
    pred_cls = np.concatenate([gt_cls, rng.integers(0, 4, size=(n, p - g))], 1)
    pred_cls[:, ::5] = rng.integers(0, 4, size=pred_cls[:, ::5].shape)
    scores = _scores(rng, n, p)
    scores[2] = scores[1]                       # ties across images
    valid = rng.uniform(size=(n, p)) > 0.15
    return (pred.astype(np.float32), scores, pred_cls, valid, gt.astype(np.float32), gt_cls,
            gt_valid)


@pytest.mark.parametrize("absent", [None, 2])
def test_mean_average_precision_matches_jax(absent):
    """mAP and per-class AP within 1e-6, duplicates and ties included; an
    absent class's entry is 0 and leaves the mean."""
    args = _map_inputs(3, absent)
    got_map, got_pc = tb.mean_average_precision(*map(torch.from_numpy, args), num_classes=4)
    ref_map, ref_pc = jb.mean_average_precision(*map(jnp.asarray, args), num_classes=4)
    assert abs(float(got_map) - float(ref_map)) <= TOL
    assert np.abs(got_pc.numpy() - np.asarray(ref_pc)).max() <= TOL
    assert 0.0 < float(got_map) < 1.0
    if absent is not None:
        assert float(got_pc[absent]) == 0.0
        assert abs(float(got_map) - float(got_pc.sum()) / 3) <= TOL


def test_mean_average_precision_is_one_on_the_ground_truth():
    args = list(_map_inputs(4))
    gt, gt_cls, gt_valid = args[4:]
    got, per_class = tb.mean_average_precision(
        torch.from_numpy(gt), torch.ones(gt_cls.shape), torch.from_numpy(gt_cls),
        torch.from_numpy(gt_valid), torch.from_numpy(gt), torch.from_numpy(gt_cls),
        torch.from_numpy(gt_valid), num_classes=4)
    assert abs(float(got) - 1.0) <= TOL and np.abs(per_class.numpy() - 1.0).max() <= TOL


def test_topk_breaks_ties_by_the_lower_index_as_jax():
    """Equal values, -inf entries and equal -inf entries in the top k: the
    values and the indices of ``jax.lax.top_k``; ``argsort_desc`` orders as
    the stable ``jnp.argsort`` of the negation."""
    rng = np.random.default_rng(5)
    x = rng.integers(0, 4, size=(6, 40)).astype(np.float32)
    x[:, 20:] = -np.inf
    x[3] = 1.0
    x[4, :] = -np.inf
    for k in (1, 7, 16, 30, 40):
        v, i = tb.topk(torch.from_numpy(x), k)
        jv, ji = jax.lax.top_k(jnp.asarray(x), k)
        np.testing.assert_array_equal(v.numpy(), np.asarray(jv))
        np.testing.assert_array_equal(i.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(tb.argsort_desc(torch.from_numpy(x)).numpy(),
                                  np.asarray(jnp.argsort(-jnp.asarray(x), axis=-1)))
    assert tb.topk(torch.from_numpy(x), 5)[1][3].tolist() == [0, 1, 2, 3, 4]
