"""Object-detection operators of the SSD / R-CNN family (port of
``mxnet_tpu/ops/detection.py``; parity: src/operator/contrib/
multibox_prior.cc, multibox_target.cc, multibox_detection.cc,
bounding_box.cc, roi_align.cc).

Plain PyTorch, batched over the leading dimension where ``mxnet_tpu``
uses ``vmap``. Every output is statically shaped: suppressed or invalid
rows are -1, as in MXNet. Where ``mxnet_tpu`` departs from MXNet 1.6 the
port follows ``mxnet_tpu`` (ROADMAP Queue 3):

- ``MultiBoxTarget`` matches each anchor to the per-gt argmax anchor
  union IoU >= ``overlap_threshold`` (``mxnet_tpu/ops/detection.py:14-17``),
  not MXNet's M-round greedy bipartite loop. When two ground truths share
  their best anchor, ``mxnet_tpu``'s scatter (``:169-171``) keeps the one
  with the higher index (XLA's CPU scatter applies updates in order); the
  port takes that gt as a max over a (B, N, M) mask, with no scatter, so
  the rule holds on CUDA too.
- Orders among ties follow ``jnp.argsort`` (stable) and ``lax.top_k``
  (lower index first): the port sorts the negated keys with
  ``torch.sort(stable=True)`` and never calls ``torch.topk``, whose order
  among ties CUDA leaves open.

NMS (:func:`_nms_sweep`) is sequential by definition: a loop over the K
score-sorted entries, batched over images, two launches an entry, with the
keep mask on the device and nothing read back to the host.
"""
from __future__ import annotations

import numpy as _np
import torch

from .registry import register

__all__ = ["multibox_prior", "multibox_target", "multibox_detection",
           "box_nms", "roi_align", "box_iou", "bipartite_matching",
           "box_encode", "box_decode", "pair_iou"]


def _listify(v):
    if isinstance(v, (int, float)):
        return (v,)
    return tuple(v)


def pair_iou(a, b):
    """IoU between corner-format box sets a (..., N, 4) and b (..., M, 4)
    -> (..., N, M) (``mxnet_tpu/ops/detection.py:38``)."""
    ax1, ay1 = a[..., :, 0:1], a[..., :, 1:2]
    ax2, ay2 = a[..., :, 2:3], a[..., :, 3:4]
    bx1, by1 = b[..., None, :, 0], b[..., None, :, 1]
    bx2, by2 = b[..., None, :, 2], b[..., None, :, 3]
    ix = (torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1)).clamp_min(0.0)
    iy = (torch.minimum(ay2, by2) - torch.maximum(ay1, by1)).clamp_min(0.0)
    inter = ix * iy
    area_a = (ax2 - ax1).clamp_min(0.0) * (ay2 - ay1).clamp_min(0.0)
    area_b = (bx2 - bx1).clamp_min(0.0) * (by2 - by1).clamp_min(0.0)
    union = area_a + area_b - inter
    return torch.where(union > 0, inter / union, torch.zeros_like(union))


@register("_contrib_MultiBoxPrior", no_grad=True, aliases=("MultiBoxPrior",))
def multibox_prior(data, sizes=(1.0,), ratios=(1.0,), clip=False,
                   steps=(-1.0, -1.0), offsets=(0.5, 0.5)):
    """Anchor boxes over the feature-map grid of ``data`` (B, C, H, W):
    (1, H*W*(len(sizes)+len(ratios)-1), 4) corner-format anchors; for each
    cell (size_i, ratio_0) for every i, then (size_0, ratio_j) for j > 0
    (``mxnet_tpu/ops/detection.py:54``)."""
    sizes = tuple(float(s) for s in _listify(sizes))
    ratios = tuple(float(r) for r in _listify(ratios))
    steps = tuple(float(s) for s in _listify(steps))
    offsets = tuple(float(o) for o in _listify(offsets))
    h, w = data.shape[2], data.shape[3]
    dev = data.device
    step_y = steps[0] if steps[0] > 0 else 1.0 / h
    step_x = steps[1] if steps[1] > 0 else 1.0 / w
    cy = (torch.arange(h, dtype=torch.float32, device=dev) + offsets[0]) \
        * step_y
    cx = (torch.arange(w, dtype=torch.float32, device=dev) + offsets[1]) \
        * step_x
    cy, cx = torch.meshgrid(cy, cx, indexing="ij")
    half_wh = [(s * _np.sqrt(ratios[0]) / 2.0, s / _np.sqrt(ratios[0]) / 2.0)
               for s in sizes]
    half_wh += [(sizes[0] * _np.sqrt(r) / 2.0, sizes[0] / _np.sqrt(r) / 2.0)
                for r in ratios[1:]]
    half = torch.tensor(_np.asarray(half_wh, _np.float32), device=dev)
    cx, cy = cx[..., None], cy[..., None]
    anchors = torch.stack([cx - half[:, 0], cy - half[:, 1],
                           cx + half[:, 0], cy + half[:, 1]], dim=-1)
    anchors = anchors.reshape(1, -1, 4)
    return anchors.clamp(0.0, 1.0) if clip else anchors


def _encode_loc(gt, anchor, variances):
    """Centre-offset encoding of corner boxes ``gt`` (..., N, 4) against
    ``anchor`` (N, 4) (``mxnet_tpu/ops/detection.py:103``)."""
    aw = anchor[:, 2] - anchor[:, 0]
    ah = anchor[:, 3] - anchor[:, 1]
    acx = (anchor[:, 0] + anchor[:, 2]) / 2
    acy = (anchor[:, 1] + anchor[:, 3]) / 2
    gw = (gt[..., 2] - gt[..., 0]).clamp_min(1e-8)
    gh = (gt[..., 3] - gt[..., 1]).clamp_min(1e-8)
    gcx = (gt[..., 0] + gt[..., 2]) / 2
    gcy = (gt[..., 1] + gt[..., 3]) / 2
    aw8, ah8 = aw.clamp_min(1e-8), ah.clamp_min(1e-8)
    return torch.stack([
        (gcx - acx) / aw8 / variances[0],
        (gcy - acy) / ah8 / variances[1],
        torch.log(gw / aw8) / variances[2],
        torch.log(gh / ah8) / variances[3]], dim=-1)


def _decode_loc(pred, anchor, variances):
    """Inverse of :func:`_encode_loc`: pred (..., N, 4) -> corner boxes."""
    aw = anchor[:, 2] - anchor[:, 0]
    ah = anchor[:, 3] - anchor[:, 1]
    acx = (anchor[:, 0] + anchor[:, 2]) / 2
    acy = (anchor[:, 1] + anchor[:, 3]) / 2
    cx = pred[..., 0] * variances[0] * aw + acx
    cy = pred[..., 1] * variances[1] * ah + acy
    w = torch.exp(pred[..., 2] * variances[2]) * aw
    h = torch.exp(pred[..., 3] * variances[3]) * ah
    return torch.stack([cx - w / 2, cy - h / 2, cx + w / 2, cy + h / 2],
                       dim=-1)


def _stable_desc(keys, dim=-1):
    """The indices that sort ``keys`` descending, ties by lower index
    first: ``jnp.argsort(-keys)`` and ``lax.top_k``'s order."""
    return torch.sort(-keys, dim=dim, stable=True).indices


def _gather_rows(x, idx):
    """x (B, N, W), idx (B, K) -> (B, K, W)."""
    return torch.gather(x, 1, idx[..., None].expand(-1, -1, x.shape[-1]))


@register("_contrib_MultiBoxTarget", num_outputs=3, no_grad=True,
          aliases=("MultiBoxTarget",))
def multibox_target(anchor, label, cls_pred, overlap_threshold=0.5,
                    ignore_label=-1.0, negative_mining_ratio=-1.0,
                    negative_mining_thresh=0.5, minimum_negative_samples=0,
                    variances=(0.1, 0.1, 0.2, 0.2)):
    """SSD training targets (``mxnet_tpu/ops/detection.py:136``): anchor
    (1, N, 4), label (B, M, 5) rows [cls, x1, y1, x2, y2] (cls < 0 pads),
    cls_pred (B, C+1, N) for hard-negative mining -> loc_target (B, N*4),
    loc_mask (B, N*4), cls_target (B, N)."""
    variances = tuple(float(v) for v in _listify(variances))
    anc = anchor.reshape(-1, 4)
    n = anc.shape[0]
    b, m = label.shape[0], label.shape[1]
    dev = anc.device
    valid = label[:, :, 0] >= 0                               # (B, M)
    gt = label[:, :, 1:5]
    iou = pair_iou(anc.expand(b, n, 4), gt)                   # (B, N, M)
    iou = torch.where(valid[:, None, :], iou, torch.full_like(iou, -1.0))
    best_iou, best_gt = iou.amax(dim=2), iou.argmax(dim=2)
    best_anchor = iou.argmax(dim=1)                           # (B, M)
    # anchor a is forced to the valid gt whose best anchor it is; of
    # several such gts, the highest index (mxnet_tpu's scatter keeps the
    # last update)
    hit = (best_anchor[:, None, :] ==
           torch.arange(n, device=dev)[None, :, None]) & valid[:, None, :]
    forced = hit.any(dim=2)
    gidx = torch.arange(m, device=dev).expand(b, n, m)
    forced_gt = torch.where(hit, gidx, torch.full_like(gidx, -1)).amax(2) \
        if m else torch.zeros((b, n), dtype=torch.long, device=dev)
    matched = forced | (best_iou >= overlap_threshold)
    match_gt = torch.where(forced, forced_gt, best_gt)
    gt_cls = torch.gather(label[:, :, 0], 1, match_gt)
    cls_t = torch.where(matched, gt_cls + 1.0, torch.zeros_like(gt_cls))
    loc_t = _encode_loc(_gather_rows(gt, match_gt), anc, variances)
    loc_m = matched[..., None].expand(b, n, 4).to(loc_t.dtype)
    loc_t = loc_t * loc_m
    if negative_mining_ratio > 0:
        neg_cand = ~matched & (best_iou < negative_mining_thresh)
        hardness = cls_pred[:, 1:, :].amax(dim=1)
        hardness = torch.where(neg_cand, hardness,
                               torch.full_like(hardness, -float("inf")))
        num_pos = matched.sum(dim=1, dtype=torch.int32).to(torch.float32)
        # a float32 product, truncated, as mxnet_tpu's (:188-190)
        num_neg = (torch.tensor(float(negative_mining_ratio),
                                dtype=torch.float32, device=dev)
                   * num_pos).to(torch.int32).clamp_min(
                       int(minimum_negative_samples))
        order = _stable_desc(hardness)
        rank = torch.empty_like(order).scatter_(
            1, order, torch.arange(n, device=dev).expand(b, n).contiguous())
        selected_neg = neg_cand & (rank < num_neg[:, None])
        cls_t = torch.where(
            matched, cls_t,
            torch.where(selected_neg, torch.zeros_like(cls_t),
                        torch.full_like(cls_t, float(ignore_label))))
    return loc_t.reshape(b, -1), loc_m.reshape(b, -1), cls_t


def _nms_sweep(boxes, ids, keep, overlap_thresh, force_suppress):
    """Greedy NMS over score-sorted entries, batched: boxes (B, K, 4),
    ids (B, K), keep (B, K) bool (the candidates) -> the kept mask. Entry i,
    if still kept, drops every later entry it suppresses
    (``mxnet_tpu/ops/detection.py:206``)."""
    k = boxes.shape[1]
    iou = pair_iou(boxes, boxes)
    suppress = iou > overlap_thresh
    if not force_suppress:
        suppress &= ids[:, :, None] == ids[:, None, :]
    suppress &= torch.ones(k, k, dtype=torch.bool,
                           device=boxes.device).triu(1)
    keep = keep.clone()
    for i in range(k):
        keep.masked_fill_(suppress[:, i] & keep[:, i, None], False)
    return keep


@register("_contrib_MultiBoxDetection", no_grad=True,
          aliases=("MultiBoxDetection",))
def multibox_detection(cls_prob, loc_pred, anchor, clip=True, threshold=0.01,
                       background_id=0, nms_threshold=0.5,
                       force_suppress=False, variances=(0.1, 0.1, 0.2, 0.2),
                       nms_topk=-1):
    """Decode and NMS (``mxnet_tpu/ops/detection.py:224``): cls_prob
    (B, C, N), loc_pred (B, N*4), anchor (1, N, 4) -> (B, N, 6) rows
    [cls_id, score, x1, y1, x2, y2], suppressed rows -1. Only the
    ``nms_topk`` best-scored anchors (all when <= 0) enter NMS."""
    variances = tuple(float(v) for v in _listify(variances))
    anc = anchor.reshape(-1, 4)
    b, n = cls_prob.shape[0], anc.shape[0]
    k = min(int(nms_topk), n) if nms_topk and nms_topk > 0 else n
    fg = torch.cat([cls_prob[:, :background_id],
                    cls_prob[:, background_id + 1:]], dim=1)
    score, cls_id = fg.amax(dim=1), fg.argmax(dim=1).to(torch.float32)
    boxes = _decode_loc(loc_pred.reshape(b, n, 4), anc, variances)
    if clip:
        boxes = boxes.clamp(0.0, 1.0)
    score_m = torch.where(score > threshold, score,
                          torch.full_like(score, -1.0))
    top_idx = _stable_desc(score_m)[:, :k]
    top_score = torch.gather(score_m, 1, top_idx)
    top_boxes = _gather_rows(boxes, top_idx)
    top_ids = torch.gather(cls_id, 1, top_idx)
    keep = _nms_sweep(top_boxes, top_ids, top_score > threshold,
                      nms_threshold, force_suppress)
    rows = torch.cat([top_ids[..., None], top_score[..., None], top_boxes],
                     dim=-1)
    out = torch.full((b, n, 6), -1.0, dtype=rows.dtype, device=rows.device)
    out[:, :k] = torch.where(keep[..., None], rows,
                             torch.full_like(rows, -1.0))
    return out


@register("_contrib_box_nms", no_grad=True, aliases=("box_nms",))
def box_nms(data, overlap_thresh=0.5, valid_thresh=0.0, topk=-1,
            coord_start=2, score_index=1, id_index=-1, background_id=-1,
            force_suppress=False, in_format="corner", out_format="corner"):
    """NMS over (..., N, W) rows; suppressed rows become -1
    (``mxnet_tpu/ops/detection.py:276``)."""
    shape = data.shape
    n, width = shape[-2], shape[-1]
    rows = data.reshape(-1, n, width)
    cs = int(coord_start)
    limit = int(topk) if topk and topk > 0 else n
    score = rows[:, :, score_index]
    ids = rows[:, :, id_index] if id_index >= 0 else \
        torch.zeros_like(score)
    valid = score > valid_thresh
    if id_index >= 0 and background_id >= 0:
        valid &= ids != background_id
    score_m = torch.where(valid, score, torch.full_like(score,
                                                        -float("inf")))
    order = _stable_desc(score_m)
    rows_s = _gather_rows(rows, order)
    boxes = rows_s[:, :, cs:cs + 4]
    if in_format == "center":
        x, y, w, h = boxes.unbind(-1)
        boxes = torch.stack([x - w / 2, y - h / 2, x + w / 2, y + h / 2], -1)
    keep = torch.isfinite(torch.gather(score_m, 1, order)) & \
        (torch.arange(n, device=data.device) < limit)
    keep = _nms_sweep(boxes, torch.gather(ids, 1, order), keep,
                      overlap_thresh, force_suppress)
    if out_format != in_format:
        coords = boxes
        if out_format == "center":
            x1, y1, x2, y2 = boxes.unbind(-1)
            coords = torch.stack([(x1 + x2) / 2, (y1 + y2) / 2, x2 - x1,
                                  y2 - y1], -1)
        rows_s = torch.cat([rows_s[:, :, :cs], coords,
                            rows_s[:, :, cs + 4:]], dim=-1)
    out = torch.where(keep[..., None], rows_s, torch.full_like(rows_s, -1.0))
    return out.reshape(shape)


@register("_contrib_ROIAlign", aliases=("ROIAlign",))
def roi_align(data, rois, pooled_size=(7, 7), spatial_scale=1.0,
              sample_ratio=-1, position_sensitive=False):
    """ROI Align (``mxnet_tpu/ops/detection.py:334``): data (B, C, H, W),
    rois (R, 5) [batch_idx, x1, y1, x2, y2] in image coordinates ->
    (R, C, PH, PW), the mean of sr x sr bilinear samples a bin (MXNet's
    convention: no half-pixel shift, samples outside [-1, H] x [-1, W]
    give 0). Differentiable: autograd runs back through the gathers."""
    ph, pw = (pooled_size if isinstance(pooled_size, (tuple, list))
              else (pooled_size, pooled_size))
    ph, pw = int(ph), int(pw)
    _, c, h, w = data.shape
    r = rois.shape[0]
    sr = int(sample_ratio) if sample_ratio and sample_ratio > 0 else 2
    if position_sensitive and c % (ph * pw):
        raise ValueError("position_sensitive ROIAlign needs channels "
                         "divisible by pooled_h*pooled_w")
    dev = data.device
    bi = rois[:, 0].to(torch.long)
    x1, y1 = rois[:, 1] * spatial_scale, rois[:, 2] * spatial_scale
    x2, y2 = rois[:, 3] * spatial_scale, rois[:, 4] * spatial_scale
    bin_w = (x2 - x1).clamp_min(1.0) / pw
    bin_h = (y2 - y1).clamp_min(1.0) / ph
    gy = y1[:, None] + (torch.arange(ph * sr, dtype=torch.float32,
                                     device=dev) + 0.5) * (bin_h / sr)[:, None]
    gx = x1[:, None] + (torch.arange(pw * sr, dtype=torch.float32,
                                     device=dev) + 0.5) * (bin_w / sr)[:, None]
    yy = gy[:, :, None].expand(r, ph * sr, pw * sr)
    xx = gx[:, None, :].expand(r, ph * sr, pw * sr)
    outside = (yy < -1.0) | (yy > h) | (xx < -1.0) | (xx > w)
    y = yy.clamp(0.0, h - 1)
    x = xx.clamp(0.0, w - 1)
    y0, x0 = torch.floor(y), torch.floor(x)
    y0i, x0i = y0.to(torch.long), x0.to(torch.long)
    y1i = (y0i + 1).clamp_max(h - 1)
    x1i = (x0i + 1).clamp_max(w - 1)
    ly, lx = (y - y0)[..., None], (x - x0)[..., None]
    b3 = bi[:, None, None]

    def at(yi, xi):                 # (R, Y, X, C)
        return data[b3, :, yi, xi]

    val = (at(y0i, x0i) * (1 - ly) * (1 - lx) + at(y0i, x1i) * (1 - ly) * lx
           + at(y1i, x0i) * ly * (1 - lx) + at(y1i, x1i) * ly * lx)
    val = torch.where(outside[..., None], torch.zeros_like(val), val)
    pooled = val.reshape(r, ph, sr, pw, sr, c).mean(dim=(2, 4))
    if position_sensitive:
        c_out = c // (ph * pw)
        pooled = pooled.reshape(r, ph, pw, c_out, ph * pw)
        bin_idx = (torch.arange(ph, device=dev)[:, None] * pw +
                   torch.arange(pw, device=dev)[None, :])
        pooled = torch.gather(
            pooled, 4, bin_idx[None, :, :, None, None].expand(
                r, ph, pw, c_out, 1))[..., 0]
    return pooled.permute(0, 3, 1, 2)


def _iou_matrix(lhs, rhs, fmt):
    """Cartesian IoU between (L, 4) and (R, 4) box lists
    (``mxnet_tpu/ops/detection.py:417``)."""
    if fmt == "corner":
        lx1, ly1, lx2, ly2 = lhs.unbind(-1)
        rx1, ry1, rx2, ry2 = rhs.unbind(-1)
        l_area = torch.where((lx2 - lx1 < 0) | (ly2 - ly1 < 0),
                             torch.zeros_like(lx1), (lx2 - lx1) * (ly2 - ly1))
        r_area = torch.where((rx2 - rx1 < 0) | (ry2 - ry1 < 0),
                             torch.zeros_like(rx1), (rx2 - rx1) * (ry2 - ry1))
    else:
        lx1, lx2 = lhs[:, 0] - lhs[:, 2] / 2, lhs[:, 0] + lhs[:, 2] / 2
        ly1, ly2 = lhs[:, 1] - lhs[:, 3] / 2, lhs[:, 1] + lhs[:, 3] / 2
        rx1, rx2 = rhs[:, 0] - rhs[:, 2] / 2, rhs[:, 0] + rhs[:, 2] / 2
        ry1, ry2 = rhs[:, 1] - rhs[:, 3] / 2, rhs[:, 1] + rhs[:, 3] / 2
        l_area = torch.where((lhs[:, 2] < 0) | (lhs[:, 3] < 0),
                             torch.zeros_like(lx1), lhs[:, 2] * lhs[:, 3])
        r_area = torch.where((rhs[:, 2] < 0) | (rhs[:, 3] < 0),
                             torch.zeros_like(rx1), rhs[:, 2] * rhs[:, 3])

    def overlap(a1, a2, b1, b2):
        return (torch.minimum(a2, b2) - torch.maximum(a1, b1)).clamp_min(0.0)

    inter = overlap(lx1[:, None], lx2[:, None], rx1[None], rx2[None]) * \
        overlap(ly1[:, None], ly2[:, None], ry1[None], ry2[None])
    union = l_area[:, None] + r_area[None] - inter
    return torch.where(inter > 0, inter / union, torch.zeros_like(inter))


@register("_contrib_box_iou", no_grad=True, aliases=("box_iou",))
def box_iou(lhs, rhs, format="corner"):  # noqa: A002
    """IoU of every lhs box against every rhs box: lhs (..., 4), rhs
    (..., 4) -> lhs.shape[:-1] + rhs.shape[:-1]
    (``mxnet_tpu/ops/detection.py:450``)."""
    out = _iou_matrix(lhs.reshape(-1, 4).float(), rhs.reshape(-1, 4).float(),
                      format)
    return out.reshape(tuple(lhs.shape[:-1]) + tuple(rhs.shape[:-1])) \
        .to(lhs.dtype)


@register("_contrib_bipartite_matching", num_outputs=2, no_grad=True,
          aliases=("bipartite_matching",))
def bipartite_matching(data, threshold=None, is_ascend=False, topk=-1):
    """Greedy bipartite matching over scores (..., N, M) -> (row_match
    (..., N), col_match (..., M)), -1 unmatched
    (``mxnet_tpu/ops/detection.py:464``): pairs are visited in score
    order, batched over the leading dimensions; the scan stops at the
    first free pair whose score fails the threshold, or once more than
    ``topk`` pairs are assigned."""
    if threshold is None:
        raise ValueError("bipartite_matching requires threshold")
    *batch, n, m = data.shape
    s = data.reshape(-1, n * m).float()
    nb, dev = s.shape[0], s.device
    order = torch.sort(s if is_ascend else -s, dim=1, stable=True).indices
    sorted_sc = torch.gather(s, 1, order)
    rows = torch.arange(nb, device=dev)
    rmark = torch.full((nb, n), -1, dtype=torch.long, device=dev)
    cmark = torch.full((nb, m), -1, dtype=torch.long, device=dev)
    count = torch.zeros(nb, dtype=torch.long, device=dev)
    stopped = torch.zeros(nb, dtype=torch.bool, device=dev)
    for j in range(n * m):
        idx = order[:, j]
        r, c = idx // m, idx % m
        score_ok = sorted_sc[:, j] < threshold if is_ascend \
            else sorted_sc[:, j] > threshold
        free = (rmark[rows, r] == -1) & (cmark[rows, c] == -1)
        do = ~stopped & free & score_ok
        rmark[rows, r] = torch.where(do, c, rmark[rows, r])
        cmark[rows, c] = torch.where(do, r, cmark[rows, c])
        count += do.long()
        stopped |= (~stopped & free & ~score_ok) | \
            (do & (topk > 0) & (count > topk))
    return (rmark.reshape(tuple(batch) + (n,)).to(data.dtype),
            cmark.reshape(tuple(batch) + (m,)).to(data.dtype))


@register("_contrib_box_encode", num_outputs=2, no_grad=True,
          aliases=("box_encode",))
def box_encode(samples, matches, anchors, refs, means, stds):
    """SSD target encoding (``mxnet_tpu/ops/detection.py:517``): samples
    (B, N) in {+1, -1, 0}, matches (B, N) indices into refs (B, M, 4),
    anchors (B, N, 4), means / stds (4,) -> (targets, masks), (B, N, 4)
    each."""
    a = anchors.float()
    ref = _gather_rows(refs.float(), matches.long())
    ref_w = ref[..., 2] - ref[..., 0]
    ref_h = ref[..., 3] - ref[..., 1]
    ref_x = ref[..., 0] + ref_w * 0.5
    ref_y = ref[..., 1] + ref_h * 0.5
    a_w = a[..., 2] - a[..., 0]
    a_h = a[..., 3] - a[..., 1]
    a_x = a[..., 0] + a_w * 0.5
    a_y = a[..., 1] + a_h * 0.5
    valid = samples.float() > 0.5
    means, stds = means.float(), stds.float()
    targets = torch.stack([
        ((ref_x - a_x) / a_w - means[0]) / stds[0],
        ((ref_y - a_y) / a_h - means[1]) / stds[1],
        (torch.log(ref_w / a_w) - means[2]) / stds[2],
        (torch.log(ref_h / a_h) - means[3]) / stds[3]], dim=-1)
    masks = valid[..., None].expand(targets.shape).float()
    targets = torch.where(valid[..., None], targets,
                          torch.zeros_like(targets))
    return targets.to(anchors.dtype), masks.to(anchors.dtype)


@register("_contrib_box_decode", no_grad=True, aliases=("box_decode",))
def box_decode(data, anchors, std0=1.0, std1=1.0, std2=1.0, std3=1.0,
               clip=-1.0, format="center"):  # noqa: A002
    """Offsets (B, N, 4) against anchors (1, N, 4) back to corner boxes;
    ``format`` names the anchors' encoding
    (``mxnet_tpu/ops/detection.py:551``)."""
    x = data.float()
    a = anchors.float().expand(x.shape)
    if format == "corner":
        a_w = a[..., 2] - a[..., 0]
        a_h = a[..., 3] - a[..., 1]
        a_x = a[..., 0] + a_w * 0.5
        a_y = a[..., 1] + a_h * 0.5
    else:
        a_x, a_y, a_w, a_h = a.unbind(-1)
    ox = x[..., 0] * std0 * a_w + a_x
    oy = x[..., 1] * std1 * a_h + a_y
    dw = x[..., 2] * std2
    dh = x[..., 3] * std3
    if clip > 0:
        dw = dw.clamp_max(clip)
        dh = dh.clamp_max(clip)
    ow = torch.exp(dw) * a_w * 0.5
    oh = torch.exp(dh) * a_h * 0.5
    return torch.stack([ox - ow, oy - oh, ox + ow, oy + oh],
                       dim=-1).to(data.dtype)
