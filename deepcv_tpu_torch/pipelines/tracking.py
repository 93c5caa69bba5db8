"""Multi-object tracking: a SORT tracker with a fixed-capacity track table.

Counterpart of ``deepcv_tpu/pipelines/tracking.py`` (``TrackerState``,
``init_tracker``, ``tracker_step``, ``track_sequence``, ``mot_metrics``):

* the tracks live in a table of ``max_tracks`` slots with an ``active``
  mask: births claim free slots, deaths clear the mask, so every frame is
  the same fixed-shape work on the device;
* SORT's constant-velocity Kalman filter (state [cx, cy, area, aspect,
  vcx, vcy, varea], measurement [cx, cy, area, aspect]) is batched over the
  table: predict by one batched matmul, update by ``torch.linalg.solve_ex``
  on (T, 4, 4);
* association is greedy best-first matching on the (T, D) IoU matrix
  (``ops/boxes.box_iou``): ``min(T, D)`` vector steps on the device, each
  taking the largest IoU left (the first flat index among ties, as
  ``jnp.argmax``) if it reaches the threshold. A step whose best IoU falls
  under it changes nothing, so every step runs and the host never reads a
  value back while a clip is tracked;
* ``track_sequence`` is a Python loop over frames; ``mot_metrics``
  (CLEAR-MOT: MOTA, id switches) likewise.

Detections are (D, 4) xyxy boxes a frame with a (D,) validity mask (the
layout of ``ops/boxes.nms`` and the detection pipelines); each gets a
track id, -1 for padding rows and when the table is full. Ids and counts
are int32, as in the JAX package.
"""
from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import torch

from deepcv_tpu_torch.ops.boxes import box_iou

__all__ = ["TrackerState", "init_tracker", "tracker_step", "track_sequence", "mot_metrics"]

_DIM_X, _DIM_Z = 7, 4


def _constants(device: torch.device):
    """SORT's F, H, Q, R and P0 (the JAX package's settings) on ``device``."""
    f = torch.eye(_DIM_X, device=device)
    f[0, 4] = f[1, 5] = f[2, 6] = 1.0
    h = torch.eye(_DIM_Z, _DIM_X, device=device)
    q = torch.diag(torch.tensor([1.0, 1.0, 1.0, 1.0, 0.01, 0.01, 1e-4], device=device))
    r = torch.diag(torch.tensor([1.0, 1.0, 10.0, 10.0], device=device))
    p0 = torch.diag(torch.tensor([10.0, 10.0, 10.0, 10.0, 1e4, 1e4, 1e4], device=device))
    return f, h, q, r, p0


def _xyxy_to_z(boxes: torch.Tensor) -> torch.Tensor:
    """(..., 4) xyxy -> (..., 4) [cx, cy, area, aspect]."""
    w = boxes[..., 2] - boxes[..., 0]
    h = boxes[..., 3] - boxes[..., 1]
    return torch.stack([boxes[..., 0] + 0.5 * w, boxes[..., 1] + 0.5 * h, w * h,
                        w / h.clamp(min=1e-6)], dim=-1)


def _x_to_xyxy(x: torch.Tensor) -> torch.Tensor:
    """(..., 7) state -> (..., 4) xyxy."""
    s = x[..., 2].clamp(min=1e-6)
    r = x[..., 3].clamp(min=1e-6)
    w = (s * r).sqrt()
    h = s / w
    return torch.stack([x[..., 0] - 0.5 * w, x[..., 1] - 0.5 * h,
                        x[..., 0] + 0.5 * w, x[..., 1] + 0.5 * h], dim=-1)


class TrackerState(NamedTuple):
    """The track table: every tensor has ``max_tracks`` rows."""
    mean: torch.Tensor               # (T, 7) Kalman means
    cov: torch.Tensor                # (T, 7, 7) Kalman covariances
    active: torch.Tensor             # (T,) bool: the slot holds a live track
    track_id: torch.Tensor           # (T,) int32 public id
    hits: torch.Tensor               # (T,) int32 matched frames
    time_since_update: torch.Tensor  # (T,) int32 frames since the last match
    next_id: torch.Tensor            # () int32 id counter


def init_tracker(max_tracks: int = 64, device=None) -> TrackerState:
    """An empty table of ``max_tracks`` slots on ``device`` (the CPU unless
    given; ``track_sequence`` puts it on its detections' device)."""
    t = int(max_tracks)
    device = torch.device("cpu" if device is None else device)
    p0 = _constants(device)[4]
    i32 = dict(dtype=torch.int32, device=device)
    return TrackerState(mean=torch.zeros(t, _DIM_X, device=device),
                        cov=p0.expand(t, _DIM_X, _DIM_X).clone(),
                        active=torch.zeros(t, dtype=torch.bool, device=device),
                        track_id=torch.full((t,), -1, **i32),
                        hits=torch.zeros(t, **i32),
                        time_since_update=torch.zeros(t, **i32),
                        next_id=torch.zeros((), **i32))


def _greedy_match(iou: torch.Tensor, valid: torch.Tensor, iou_threshold: float
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Greedy best-first matching on a (T, D) IoU matrix where ``valid``:
    (track_match (T,), det_match (D,)) as int64, -1 where unmatched. Each of
    the ``min(T, D)`` steps takes the largest entry left (``max`` returns
    the first flat index among ties) and, when it reaches the threshold,
    matches its pair and clears its row and column. The matrix carries one
    more row and column, which a step that matches nothing clears instead,
    so that every step is the same few launches; the pairs are scattered
    into the two tables once, after the last step (a matched row or column
    is cleared, so no two steps write one slot)."""
    t, d = iou.shape
    m = torch.full((t + 1, d + 1), -1.0, dtype=iou.dtype, device=iou.device)
    m[:t, :d] = torch.where(valid, iou, -1.0)
    picks = []
    for _ in range(min(t, d)):
        best, flat = m.reshape(-1).max(0)
        ok = best >= iou_threshold
        ti = torch.where(ok, flat // (d + 1), t)
        di = torch.where(ok, flat % (d + 1), d)
        m.index_fill_(0, ti.reshape(1), -1.0)
        m.index_fill_(1, di.reshape(1), -1.0)
        picks.append(torch.stack([ti, di]))
    tm = torch.full((t + 1,), -1, dtype=torch.long, device=iou.device)
    dm = torch.full((d + 1,), -1, dtype=torch.long, device=iou.device)
    if picks:
        ti, di = torch.stack(picks, 1)
        tm[ti] = torch.where(di < d, di, -1)
        dm[di] = torch.where(ti < t, ti, -1)
    return tm[:t], dm[:d]


def tracker_step(state: TrackerState, boxes: torch.Tensor, det_mask: torch.Tensor, *,
                 iou_threshold: float = 0.3, max_age: int = 3
                 ) -> Tuple[TrackerState, torch.Tensor]:
    """Advance the tracker by one frame of (D, 4) xyxy ``boxes`` whose
    (D,) ``det_mask`` is True on real rows: predict every slot, match by
    IoU (at least ``iou_threshold``), update the matched tracks, retire
    those unseen for more than ``max_age`` frames, and give each unmatched
    detection a free slot (lowest slot to lowest detection) and a new id.
    Returns the new state and the (D,) int32 ids (-1 for padding rows and
    births that found no free slot)."""
    dev = boxes.device
    f_mat, h_mat, q_mat, r_mat, p0 = _constants(dev)
    boxes = boxes.float()
    d = boxes.shape[0]
    t = state.active.shape[0]
    slots = torch.arange(t, device=dev)

    # 1. predict every slot (inactive ones predict values the masks ignore)
    mean = state.mean @ f_mat.T
    cov = f_mat @ state.cov @ f_mat.T + q_mat

    # 2. associate the predicted boxes with the detections
    valid = state.active[:, None] & det_mask[None, :]
    track_match, det_match = _greedy_match(box_iou(_x_to_xyxy(mean), boxes), valid,
                                           iou_threshold)
    matched = track_match >= 0

    # 3. Kalman-update the matched tracks with their measurements
    z_all = _xyxy_to_z(boxes)
    z = z_all[track_match.clamp(0, d - 1)]
    hp = h_mat @ cov                                               # (T, 4, 7)
    s = hp @ h_mat.T + r_mat
    gain = torch.linalg.solve_ex(s, hp)[0].transpose(-1, -2)       # (T, 7, 4)
    mean_u = mean + (gain @ (z - mean @ h_mat.T)[..., None])[..., 0]
    cov_u = (torch.eye(_DIM_X, device=dev) - gain @ h_mat) @ cov
    mean = torch.where(matched[:, None], mean_u, mean)
    cov = torch.where(matched[:, None, None], cov_u, cov)
    hits = state.hits + matched.int()
    tsu = torch.where(matched, 0, state.time_since_update + 1).int()

    # 4. retire tracks unseen for more than max_age frames
    active = state.active & (tsu <= max_age)

    # 5. births: unmatched real detections claim free slots, both in index order
    free = ~active
    slot_order = torch.argsort(torch.where(free, slots, t + slots), stable=True)
    is_birth = det_mask & (det_match < 0)
    birth_rank = torch.cumsum(is_birth.long(), 0) - 1
    can_place = is_birth & (birth_rank < free.sum())
    birth_slot = slot_order[birth_rank.clamp(0, t - 1)]
    # one row past the table takes the writes of the births that found no slot
    slot_det = torch.full((t + 1,), -1, dtype=torch.long, device=dev)
    slot_det[torch.where(can_place, birth_slot, t)] = torch.arange(d, device=dev)
    slot_det = slot_det[:t]
    is_new = slot_det >= 0
    mean_new = torch.cat([z_all[slot_det.clamp(0, d - 1)], mean.new_zeros(t, 3)], dim=-1)
    mean = torch.where(is_new[:, None], mean_new, mean)
    cov = torch.where(is_new[:, None, None], p0, cov)
    hits = torch.where(is_new, 1, hits).int()
    tsu = torch.where(is_new, 0, tsu).int()
    new_ids = state.next_id + torch.cumsum(is_new.int(), 0) - 1
    track_id = torch.where(is_new, new_ids, state.track_id).int()
    next_id = (state.next_id + is_new.sum()).int()

    # 6. each detection's id: its track's if matched, its new track's if born
    ids = torch.where(det_match >= 0, track_id[det_match.clamp(0, t - 1)], -1)
    ids = torch.where(can_place, track_id[birth_slot], ids).int()
    return TrackerState(mean=mean, cov=cov, active=active | is_new, track_id=track_id,
                        hits=hits, time_since_update=tsu, next_id=next_id), ids


def track_sequence(detections: torch.Tensor, det_masks: torch.Tensor, *,
                   max_tracks: int = 64, iou_threshold: float = 0.3,
                   max_age: int = 3) -> torch.Tensor:
    """Track a clip of (F, D, 4) xyxy detections with (F, D) masks on their
    device: the (F, D) int32 ids."""
    state = init_tracker(max_tracks, device=detections.device)
    out = []
    for boxes, mask in zip(detections, det_masks.bool()):
        state, ids = tracker_step(state, boxes, mask, iou_threshold=iou_threshold,
                                  max_age=max_age)
        out.append(ids)
    return torch.stack(out)


def mot_metrics(gt_boxes: torch.Tensor, gt_ids: torch.Tensor, gt_masks: torch.Tensor,
                pred_boxes: torch.Tensor, pred_ids: torch.Tensor, pred_masks: torch.Tensor, *,
                iou_threshold: float = 0.5, max_gt_ids: int = 256) -> Dict[str, torch.Tensor]:
    """CLEAR-MOT over a clip: per frame, predictions are matched greedily to
    the ground truth by IoU (at least ``iou_threshold``); unmatched ground
    truth are misses, unmatched predictions false positives; an id switch
    is a ground-truth identity matched to another predicted id than at its
    last match (the memory survives gaps), kept in a table of
    ``max_gt_ids`` identities. Rows with a predicted id below 0 do not
    count as predictions.

    ``gt_boxes`` (F, G, 4) xyxy, ``gt_ids`` (F, G) in [0, max_gt_ids),
    ``gt_masks`` (F, G); ``pred_boxes`` (F, D, 4), ``pred_ids`` (F, D) (say
    :func:`track_sequence`'s), ``pred_masks`` (F, D). Returns ``mota`` = 1 -
    (misses + false positives + id switches) / ground truth (float32) and
    the int32 counts ``misses``, ``false_positives``, ``id_switches``,
    ``num_gt`` and ``matches``."""
    dev = gt_boxes.device
    pred_masks = pred_masks.bool() & (pred_ids >= 0)
    # one row past the table takes the writes of unmatched rows
    last_id = torch.full((max_gt_ids + 1,), -1, dtype=torch.long, device=dev)
    fn = fp = idsw = ngt = nmatch = torch.zeros((), dtype=torch.long, device=dev)
    for gb, gi, gm, pb, pi, pm in zip(gt_boxes.float(), gt_ids.long(), gt_masks.bool(),
                                      pred_boxes.float(), pred_ids.long(), pred_masks):
        g_match, d_match = _greedy_match(box_iou(gb, pb), gm[:, None] & pm[None, :],
                                         iou_threshold)
        matched = g_match >= 0
        ngt = ngt + gm.sum()
        fn = fn + (gm & ~matched).sum()
        fp = fp + (pm & (d_match < 0)).sum()
        nmatch = nmatch + matched.sum()
        pid = torch.where(matched, pi[g_match.clamp(0, pi.shape[0] - 1)], -1)
        gid = gi.clamp(0, max_gt_ids - 1)
        prev = last_id[gid]
        idsw = idsw + (matched & (prev >= 0) & (prev != pid)).sum()
        last_id[torch.where(matched, gid, max_gt_ids)] = torch.where(matched, pid, -1)
    mota = 1.0 - (fn + fp + idsw).float() / ngt.clamp(min=1).float()
    return {"mota": mota, "misses": fn.int(), "false_positives": fp.int(),
            "id_switches": idsw.int(), "num_gt": ngt.int(), "matches": nmatch.int()}
