"""Detection (SSD family) rules.

Parity: the JAX package's fluid/ops_impl/detection_ops.py (prior_box :15,
box_coder :70, _iou :98, _bipartite_greedy :114, _match :144,
iou_similarity :156, bipartite_match :164, target_assign :176, _nms_class
:196, multiclass_nms :229, anchor_generator :279, _encode_boxes :305,
ssd_loss :321, rpn_target_assign :395, detection_map :447; reference
paddle/fluid/operators/detection/*). Masked dense torch: the NMS output is
a fixed [B, keep_top_k, 6] block padded with label -1 rows, as in JAX.

What a captured step needs: no rule reads the card from the host. The
JAX rules' lax.fori_loops are Python loops of device ops with a static
trip count, each vectorised over every independent axis:

  * the greedy bipartite match runs min(G, P) steps over the batch at
    once;
  * NMS runs min(nms_top_k, M) steps over [B, C'] at once, on the IoU of
    each class's top-k candidates ([B, C', k, k]; the JAX rule indexes a
    per-class [M, M] matrix, which at B 32, C' 20, M 2,278 would be 13 GB);
  * detection_map walks K steps over [C', B] at once: image b's matches
    depend on image b's detections alone, taken in descending score order
    (a stable per-image sort), and each detection's tp / fp is then put at
    its place in the class's stable sort over the whole batch before the
    cumulative sums. The JAX rule walks the B * K detections of each class
    one at a time.

On meta tensors (build-time shape inference) each loop runs one step.

Sorts are stable (jnp.argsort is), NaN last, -0.0 equal to +0.0, as
torch.sort orders them; argmax takes the first maximum, as jnp.argmax;
the scatters are deterministic (a scatter-max, a scatter of unique
indices). Match indices and target labels are int64 (int32 in JAX).
Departure: the layer detection_output passes scores_layout='BMC' (the
JAX layer omits it, so its multiclass_nms reads [B, M, C] softmax scores
as [B, C, M]); the rule itself reads the attr as the JAX rule does.
"""
import math

import torch

from ..lowering import register, data_of, SeqValue
from .nn_ops import take_along_last
from .math_ops import _abs

_BIG_NEG = -1e9
# the reference bipartite_match_op.cc matches only where dist > kEPS
_MATCH_EPS = 1e-6


def _steps(t, n):
    """The trip count of a loop over tensor t's work: n, or 1 on meta."""
    return min(n, 1) if t.device.type == 'meta' else n


def _full(t, value):
    """A 0-d tensor of t's dtype and device (a device fill, no host
    copy)."""
    return t.new_full((), value)


def _valid_rows(v):
    """[B, G] bool: row g of image b lies within its lod length (every row
    of a dense value)."""
    d = data_of(v)
    if not isinstance(v, SeqValue):
        return torch.ones(tuple(d.shape[:2]), dtype=torch.bool,
                          device=d.device)
    return torch.arange(d.shape[1], device=d.device)[None] \
        < v.lengths[:, None]


def _inverse_rank(keys):
    """The rank of each entry of keys [B, A] in its row's stable ascending
    sort (argsort of argsort)."""
    order = torch.argsort(keys, dim=1, stable=True)
    return torch.empty_like(order).scatter_(
        1, order, torch.arange(keys.shape[1], device=keys.device)
        .expand_as(order))


def _box_grid(feat, half_sizes, step, offset, variances, norm=None,
              clip=False):
    """[fh, fw, n, 4] corner boxes of the (half width, half height) pairs
    centred on feat's [fh, fw] grid at `step` (x, y) from `offset`, each
    coordinate divided by `norm` (the image's width and height) where
    given; and their variances, the same shape (device fills)."""
    fh, fw = feat.shape[2], feat.shape[3]
    dev = feat.device
    cx = (torch.arange(fw, device=dev) + offset) * step[0]
    cy = (torch.arange(fh, device=dev) + offset) * step[1]
    cxg, cyg = torch.meshgrid(cx, cy, indexing='xy')   # [fh, fw]
    boxes = []
    for bw, bh in half_sizes:
        corners = [cxg - bw, cyg - bh, cxg + bw, cyg + bh]
        if norm is not None:
            corners = [c / norm[i % 2] for i, c in enumerate(corners)]
        boxes.append(torch.stack(corners, dim=-1))
    out = torch.stack(boxes, dim=2)
    if clip:
        out = torch.clamp(out, 0.0, 1.0)
    var = torch.stack([out.new_full(out.shape[:-1], float(v))
                       for v in variances], -1)
    return out, var


@register('prior_box')
def _prior_box(ins, attrs, ctx):
    """reference operators/detection/prior_box_op.cc; the JAX :15-67."""
    feat = data_of(ins['Input'][0])       # NCHW feature map
    img = data_of(ins['Image'][0])
    min_sizes = list(attrs['min_sizes'])
    max_sizes = list(attrs.get('max_sizes', []) or [])
    full_ars = [1.0]
    for ar in attrs.get('aspect_ratios', [1.0]):
        if abs(ar - 1.0) < 1e-6:
            continue
        full_ars.append(ar)
        if attrs.get('flip', False):
            full_ars.append(1.0 / ar)
    half = []
    for ms in min_sizes:
        for ar in full_ars:
            half.append((ms * math.sqrt(ar) / 2.0, ms / math.sqrt(ar) / 2.0))
        if max_sizes:
            s = math.sqrt(ms * max_sizes[min_sizes.index(ms)]) / 2.0
            half.append((s, s))
    fh, fw = feat.shape[2], feat.shape[3]
    ih, iw = img.shape[2], img.shape[3]
    step_w, step_h = attrs.get('step_w', 0.0), attrs.get('step_h', 0.0)
    step = (step_w if step_w > 0 else iw / fw,
            step_h if step_h > 0 else ih / fh)
    boxes, var = _box_grid(
        feat, half, step, attrs.get('offset', 0.5),
        attrs.get('variances', [0.1, 0.1, 0.2, 0.2]), norm=(iw, ih),
        clip=attrs.get('clip', False))
    return {'Boxes': boxes, 'Variances': var}


@register('anchor_generator')
def _anchor_generator(ins, attrs, ctx):
    """reference operators/detection/anchor_generator_op.cc; the JAX
    :279-302: anchors in pixels, aspect ratio slowest."""
    half = []
    for ar in attrs.get('aspect_ratios', [1.0]):
        for s in attrs.get('anchor_sizes', [64.0]):
            half.append((s * math.sqrt(ar) / 2.0, s / math.sqrt(ar) / 2.0))
    anchors, var = _box_grid(
        data_of(ins['Input'][0]), half,
        list(attrs.get('stride', [16.0, 16.0])),
        float(attrs.get('offset', 0.5)),
        attrs.get('variances', [0.1, 0.1, 0.2, 0.2]))
    return {'Anchors': anchors, 'Variances': var}


def _encode_boxes(gt, priors, pvar):
    """Center-size encode gt [*, 4] against priors [*, 4] (the JAX
    :305-318)."""
    pw = priors[..., 2] - priors[..., 0]
    ph = priors[..., 3] - priors[..., 1]
    pcx = priors[..., 0] + 0.5 * pw
    pcy = priors[..., 1] + 0.5 * ph
    eps = _full(gt, 1e-6)
    gw = torch.maximum(gt[..., 2] - gt[..., 0], eps)
    gh = torch.maximum(gt[..., 3] - gt[..., 1], eps)
    gcx = gt[..., 0] + 0.5 * gw
    gcy = gt[..., 1] + 0.5 * gh
    return torch.stack([(gcx - pcx) / pw / pvar[..., 0],
                        (gcy - pcy) / ph / pvar[..., 1],
                        torch.log(gw / pw) / pvar[..., 2],
                        torch.log(gh / ph) / pvar[..., 3]], dim=-1)


@register('box_coder')
def _box_coder(ins, attrs, ctx):
    """reference operators/detection/box_coder_op.cc. decode_center_size:
    TargetBox [N, M, 4] offsets against PriorBox [M, 4]; encode: gt boxes
    [N, 4] against the priors -> [N, M, 4]."""
    prior = data_of(ins['PriorBox'][0])
    pvar = data_of(ins['PriorBoxVar'][0]) if ins.get('PriorBoxVar') \
        else torch.ones_like(prior)
    target = data_of(ins['TargetBox'][0])
    if 'decode' in attrs.get('code_type', 'decode_center_size'):
        pw = prior[:, 2] - prior[:, 0]
        ph = prior[:, 3] - prior[:, 1]
        pcx = prior[:, 0] + 0.5 * pw
        pcy = prior[:, 1] + 0.5 * ph
        tcx = pvar[..., 0] * target[..., 0] * pw + pcx
        tcy = pvar[..., 1] * target[..., 1] * ph + pcy
        tw = torch.exp(pvar[..., 2] * target[..., 2]) * pw
        th = torch.exp(pvar[..., 3] * target[..., 3]) * ph
        out = torch.stack([tcx - tw / 2, tcy - th / 2,
                           tcx + tw / 2, tcy + th / 2], dim=-1)
    else:
        out = _encode_boxes(target[:, None, :], prior[None], pvar[None])
    return {'OutputBox': out}


def _iou(a, b):
    """IoU matrix between a [..., N, 4] and b [..., M, 4] -> [..., N, M];
    torch.maximum / minimum split a tie's gradient as jnp's do."""
    ax1, ay1, ax2, ay2 = (a[..., :, None, i] for i in range(4))
    bx1, by1, bx2, by2 = (b[..., None, :, i] for i in range(4))
    zero = _full(a, 0.0)
    iw = torch.maximum(torch.minimum(ax2, bx2) - torch.maximum(ax1, bx1),
                       zero)
    ih = torch.maximum(torch.minimum(ay2, by2) - torch.maximum(ay1, by1),
                       zero)
    inter = iw * ih
    area_a = torch.maximum(ax2 - ax1, zero) * torch.maximum(ay2 - ay1, zero)
    area_b = torch.maximum(bx2 - bx1, zero) * torch.maximum(by2 - by1, zero)
    union = area_a + area_b - inter
    return torch.where(union > 0,
                       inter / torch.maximum(union, _full(union, 1e-10)),
                       zero)


def _bipartite_greedy(dist):
    """Greedy bipartite matching on dist [B, N, M] (rows gt, columns
    priors), every image at once: min(N, M) global-argmax steps, each
    matching its row and column and striking both out (the JAX :114-141,
    a fori_loop per image). Returns (col_to_row [B, M] int64,
    col_dist [B, M]); -1 where unmatched."""
    B, N, M = dist.shape
    dev = dist.device
    rows = torch.arange(N, device=dev)[None, :, None]
    cols = torch.arange(M, device=dev)
    col_match = torch.full((B, M), -1, dtype=torch.int64, device=dev)
    col_dist = dist.new_zeros((B, M))
    d = dist
    for _ in range(_steps(dist, min(N, M))):
        flat = torch.argmax(d.reshape(B, -1), dim=1)           # first max
        r, c = flat // M, flat % M
        val = d.reshape(B, -1).gather(1, flat[:, None])[:, 0]
        ok = val > _MATCH_EPS
        hit = ok[:, None] & (cols[None] == c[:, None])
        col_match = torch.where(hit, r[:, None], col_match)
        col_dist = torch.where(hit, val[:, None], col_dist)
        strike = ok[:, None, None] & ((rows == r[:, None, None])
                                      | (cols == c[:, None, None]))
        d = d.masked_fill(strike, _BIG_NEG)
    return col_match, col_dist


def _match(dist, match_type, threshold):
    """Bipartite, then for per_prediction every unmatched column whose best
    row passes the threshold (the JAX :144-153); dist [B, N, M]."""
    col_match, col_dist = _bipartite_greedy(dist)
    if match_type == 'per_prediction':
        best_row = torch.argmax(dist, dim=1)
        best_val = torch.amax(dist, dim=1)
        fill = (col_match < 0) & (best_val > threshold)
        col_match = torch.where(fill, best_row, col_match)
        col_dist = torch.where(fill, best_val, col_dist)
    return col_match, col_dist


@register('iou_similarity')
def _iou_similarity(ins, attrs, ctx):
    """reference operators/detection/iou_similarity_op.cc."""
    return {'Out': _iou(data_of(ins['X'][0]), data_of(ins['Y'][0]))}


@register('bipartite_match')
def _bipartite_match(ins, attrs, ctx):
    """DistMat [N, M] (one image: the outputs gain a batch dim of 1) or
    [B, N, M]."""
    dist = data_of(ins['DistMat'][0])
    m, d = _match(dist[None] if dist.ndim == 2 else dist,
                  attrs.get('match_type', 'bipartite'),
                  float(attrs.get('dist_threshold', 0.5)))
    return {'ColToRowMatchIndices': m, 'ColToRowMatchDist': d}


@register('target_assign')
def _target_assign(ins, attrs, ctx):
    """Per-prior targets gathered by match index (reference
    operators/detection/target_assign_op.cc): X [B, N, K], MatchIndices
    [B, M] -> Out [B, M, K], mismatched rows mismatch_value with
    OutWeight [B, M, 1] 0. A mismatch_value of None (the layer's default)
    is the reference's 0; the JAX rule raises on it."""
    x = data_of(ins['X'][0])
    match = data_of(ins['MatchIndices'][0]).long()
    mval = attrs.get('mismatch_value', 0)
    mval = 0 if mval is None else mval
    batch = torch.arange(x.shape[0], device=x.device)[:, None]
    out = x[batch, match.clamp_min(0)]
    ok = (match >= 0)[..., None]
    out = out.masked_fill(~ok.reshape(ok.shape + (1,) * (out.ndim - 3)),
                          mval)
    return {'Out': out, 'OutWeight': ok.to(torch.float32)}


def _nms_keep(iou, valid, threshold, eta):
    """Greedy suppression over score-sorted candidates: iou [..., k, k],
    valid [..., k] -> keep [..., k], every leading index at once (the JAX
    :196-226 loop body). Step i keeps candidate i unless an earlier kept
    one suppressed it, then suppresses the candidates it overlaps past the
    threshold; a candidate at or before i is never read again, so the
    rule's `later` mask is not needed. The adaptive threshold (eta < 1)
    decays after a kept box while it is above 0.5."""
    k = valid.shape[-1]
    keep = torch.zeros_like(valid)
    suppressed = torch.zeros_like(valid)
    adaptive = eta < 1.0
    if adaptive:
        thr = iou.new_full(valid.shape[:-1], threshold)
    else:
        over = iou > threshold
    for i in range(_steps(iou, k)):
        cur = valid[..., i] & ~suppressed[..., i]
        keep[..., i] = cur
        row = iou[..., i, :] > thr[..., None] if adaptive else over[..., i, :]
        suppressed |= row & cur[..., None]
        if adaptive:
            thr = torch.where(cur & (thr > 0.5), thr * eta, thr)
    return keep


def _drop_class(t, dim, bg):
    """t without index bg along dim (no host copy of an index list)."""
    n = t.shape[dim]
    if not 0 <= bg < n:
        return t
    return torch.cat([t.narrow(dim, 0, bg), t.narrow(dim, bg + 1,
                                                     n - bg - 1)], dim)


@register('multiclass_nms')
def _multiclass_nms(ins, attrs, ctx):
    """reference operators/detection/multiclass_nms_op.cc; the JAX
    :229-276. BBoxes [B, M, 4], Scores [B, C, M] ('BCM', the reference's
    layout) or [B, M, C] ('BMC'). Out: DENSE [B, keep_top_k, 6] (label,
    score, box) padded with label -1 rows: per class the top
    min(nms_top_k, M) candidates by score, greedy IoU suppression among
    them, then the keep_top_k best kept boxes over all classes."""
    boxes = data_of(ins['BBoxes'][0])
    scores = data_of(ins['Scores'][0])
    if attrs.get('scores_layout', 'BCM') == 'BMC':
        scores = scores.transpose(1, 2)
    B, C, M = scores.shape
    bg = int(attrs.get('background_label', 0))
    nms_top_k = int(attrs.get('nms_top_k', 400))
    keep_top_k = int(attrs.get('keep_top_k', 200))
    cls_scores = _drop_class(scores, 1, bg)               # [B, C', M]
    Cp = cls_scores.shape[1]
    k = min(nms_top_k, M) if nms_top_k > 0 else M
    order = torch.argsort(-cls_scores, dim=-1, stable=True)[..., :k]
    ss = torch.gather(cls_scores, -1, order)
    cand = torch.gather(boxes[:, None].expand(B, Cp, M, 4), 2,
                        order[..., None].expand(B, Cp, k, 4))
    keep = _nms_keep(_iou(cand, cand),
                     ss > float(attrs.get('score_threshold', 0.01)),
                     float(attrs.get('nms_threshold', 0.3)),
                     float(attrs.get('nms_eta', 1.0)))
    kept = torch.zeros((B, Cp, M), dtype=torch.bool,
                       device=scores.device).scatter_(-1, order, keep)
    all_scores = cls_scores.masked_fill(~kept, -1.0).reshape(B, Cp * M)
    k2 = min(keep_top_k, Cp * M)
    top = torch.argsort(-all_scores, dim=-1, stable=True)[:, :k2]
    ts = torch.gather(all_scores, 1, top)
    ci = top // M
    label = (ci + (ci >= bg).long() if 0 <= bg < C else ci).to(ts.dtype)
    tb = torch.gather(boxes, 1, (top % M)[..., None].expand(B, k2, 4))
    ok = ts > 0
    row = torch.cat([label.masked_fill(~ok, -1.0)[..., None],
                     ts.masked_fill(~ok, 0.0)[..., None],
                     tb.masked_fill(~ok[..., None], 0.0)], dim=-1)
    if k2 < keep_top_k:
        row = torch.cat([row, row.new_full((B, keep_top_k - k2, 6), -1.0)],
                        dim=1)
    return {'Out': row}


@register('ssd_loss')
def _ssd_loss(ins, attrs, ctx):
    """The fused SSD loss of the JAX :321-392 (reference
    layers/detection.py:ssd_loss composes 13 ops), every image at once:
    per-prediction matching of the valid gt rows (the padded ones at
    -1e9), smooth-L1 on matched localizations, softmax cross entropy,
    max-negative mining at neg_pos_ratio among priors whose best overlap
    is below neg_overlap. Loss [B, 1], summed over priors and divided by
    the batch's positive count."""
    loc = data_of(ins['Loc'][0])                 # [B, P, 4]
    conf = data_of(ins['Conf'][0])               # [B, P, C]
    gt_box_v = ins['GtBox'][0]
    gt_box = data_of(gt_box_v)                   # [B, G, 4]
    B = gt_box.shape[0]
    gt_lbl = data_of(ins['GtLabel'][0]).reshape(B, -1).long()
    priors = data_of(ins['PriorBox'][0]).reshape(-1, 4)
    pvar = data_of(ins['PriorBoxVar'][0]).reshape(-1, 4) \
        if ins.get('PriorBoxVar') else torch.ones_like(priors)
    bg = int(attrs.get('background_label', 0))
    neg_ratio = float(attrs.get('neg_pos_ratio', 3.0))
    P = priors.shape[0]

    valid_gt = _valid_rows(gt_box_v)[..., None]              # [B, G, 1]
    raw_iou = _iou(gt_box, priors)                           # [B, G, P]
    match, _ = _match(raw_iou.masked_fill(~valid_gt, _BIG_NEG),
                      attrs.get('match_type', 'per_prediction'),
                      float(attrs.get('overlap_threshold', 0.5)))
    pos = match >= 0
    n_pos = pos.sum(1)
    safe = match.clamp_min(0)
    matched_gt = torch.gather(gt_box, 1, safe[..., None].expand(B, P, 4))
    diff = loc - _encode_boxes(matched_gt, priors, pvar)
    ad = _abs(diff)
    smooth = torch.where(ad < 1.0, 0.5 * ad * ad, ad - 0.5).sum(-1)
    loc_loss = smooth * pos

    labels = torch.gather(gt_lbl, 1, safe).masked_fill(~pos, bg)
    logp = torch.log_softmax(conf, dim=-1)
    ce = -take_along_last(logp, labels[..., None])[..., 0]
    with torch.no_grad():
        best_iou = raw_iou.masked_fill(~valid_gt, 0.0).amax(1)
        neg_cand = ~pos & (best_iou < float(attrs.get('neg_overlap', 0.5)))
        neg_loss = ce.masked_fill(~neg_cand, float('-inf'))
        n_neg = torch.minimum((neg_ratio * n_pos).long(), neg_cand.sum(1))
        neg_sel = neg_cand & (_inverse_rank(-neg_loss) < n_neg[:, None])
    conf_loss = ce * (pos | neg_sel)
    total = float(attrs.get('loc_loss_weight', 1.0)) * loc_loss \
        + float(attrs.get('conf_loss_weight', 1.0)) * conf_loss
    loss = total.sum(1)
    if bool(attrs.get('normalize', True)):
        loss = loss / torch.clamp_min(n_pos.sum().to(loss.dtype), 1.0)
    return {'Loss': loss[:, None]}


@register('rpn_target_assign')
def _rpn_target_assign(ins, attrs, ctx):
    """The JAX :395-444 (reference layers/detection.py:rpn_target_assign):
    exactly rpn_batch_size_per_im samples an image, label -1 marking the
    unused slots, every image at once. Positives: anchors whose best IoU
    passes rpn_positive_overlap, and each valid gt's best anchor (a
    scatter-max, which ORs duplicate indices deterministically); negatives
    below rpn_negative_overlap; the top-IoU positives up to the fg
    fraction, then the lowest-IoU negatives; the selected slots first in
    anchor order."""
    loc = data_of(ins['Loc'][0])                 # [B, A, 4]
    scores = data_of(ins['Score'][0])            # [B, A, 1]
    anchors = data_of(ins['AnchorBox'][0]).reshape(-1, 4)
    gt_v = ins['GtBox'][0]
    gt = data_of(gt_v)                           # [B, G, 4]
    B = gt.shape[0]
    S = int(attrs.get('rpn_batch_size_per_im', 256))
    n_fg = int(S * float(attrs.get('fg_fraction', 0.25)))
    valid_gt = _valid_rows(gt_v)
    with torch.no_grad():
        iou = _iou(gt, anchors).masked_fill(~valid_gt[..., None], 0.0)
        best_gt = torch.argmax(iou, dim=1)                   # [B, A]
        best_iou = torch.amax(iou, dim=1)
        pos = (best_iou > float(attrs.get('rpn_positive_overlap', 0.7)))
        best_anchor = torch.argmax(iou, dim=2)               # [B, G]
        pos = pos.long().scatter_reduce(1, best_anchor, valid_gt.long(),
                                        'amax', include_self=True).bool()
        neg = (best_iou < float(attrs.get('rpn_negative_overlap', 0.3))) \
            & ~pos
        pos_sel = pos & (_inverse_rank(-best_iou.masked_fill(~pos, -1.0))
                         < n_fg)
        n_neg = S - pos_sel.sum(1)
        neg_sel = neg & (_inverse_rank(best_iou.masked_fill(~neg, 2.0))
                         < n_neg[:, None])
        idx = torch.argsort((~(pos_sel | neg_sel)).to(torch.int32), dim=1,
                            stable=True)[:, :S]
        lbl = torch.where(pos_sel, 1, torch.where(neg_sel, 0, -1))
        matched = torch.gather(gt, 1, best_gt[..., None].expand(
            B, best_gt.shape[1], 4))
        tgt_box = _encode_boxes(matched, anchors, torch.ones_like(anchors))
    n = idx.shape[1]

    def take(t):
        return torch.gather(t, 1, idx[..., None].expand(B, n, t.shape[-1]))

    return {'PredScore': take(scores), 'PredLoc': take(loc),
            'TargetLabel': torch.gather(lbl, 1, idx)[..., None],
            'TargetBox': take(tgt_box)}


@register('detection_map')
def _detection_map(ins, attrs, ctx):
    """Integral-AP mAP over one batch (reference operators/detection/
    detection_map_op.cc; the JAX :447-504): DetectRes is the dense
    multiclass_nms output [B, K, 6], Label [B, G, >=5] (label, box), a
    lod value. Each class's detections are walked in descending score
    order, each matching the best unused gt box of its class in its image
    at overlap_threshold; AP = sum(precision * tp) / n_gt, classes with no
    gt left out of the mean."""
    det = data_of(ins['DetectRes'][0])           # [B, K, 6]
    lab_v = ins['Label'][0]
    lab = data_of(lab_v)                         # [B, G, >=5]
    B, G = lab.shape[0], lab.shape[1]
    K = det.shape[1]
    dev = det.device
    C = int(attrs['class_num'])
    bg = int(attrs.get('background_label', 0))
    thr = float(attrs.get('overlap_threshold', 0.3))
    if attrs.get('ap_type', 'integral') != 'integral':
        raise ValueError("detection_map: only ap_version='integral' is "
                         "implemented")
    gt_valid = _valid_rows(lab_v)
    cls = _drop_class(torch.arange(C, device=dev, dtype=det.dtype), 0, bg)
    Cp = cls.shape[0]
    cl = cls[:, None, None]
    scores = torch.where(det[None, ..., 0] == cl, det[None, ..., 1],
                         _full(det, -1.0))                   # [C', B, K]
    gt_c = gt_valid[None] & (lab[None, ..., 0] == cl)        # [C', B, G]
    n_gt = gt_c.sum((1, 2))

    # image b's walk: its detections of the class in stable score order
    ord_b = torch.argsort(-scores, dim=-1, stable=True)
    s_sorted = torch.gather(scores, -1, ord_b)
    iou_all = _iou(det[..., 2:6], lab[..., 1:5])             # [B, K, G]
    iou_sorted = torch.gather(iou_all[None].expand(Cp, B, K, G), 2,
                              ord_b[..., None].expand(Cp, B, K, G))
    used = torch.zeros((Cp, B, G), dtype=torch.bool, device=dev)
    hits = torch.zeros((Cp, B, K), dtype=torch.bool, device=dev)
    gidx = torch.arange(G, device=dev)
    minus_one = _full(det, -1.0)
    for t in range(_steps(det, K)):
        m = torch.where(gt_c & ~used, iou_sorted[:, :, t], minus_one)
        j = torch.argmax(m, dim=-1)
        best = torch.gather(m, -1, j[..., None])[..., 0]
        hit = (s_sorted[..., t] > 0) & (best >= thr)
        used |= hit[..., None] & (gidx == j[..., None])
        hits[..., t] = hit
    fp_sorted = (s_sorted > 0) & ~hits
    # each detection's tp / fp at its place in the class's stable sort
    # over the whole batch
    order = torch.argsort(-scores.reshape(Cp, B * K), dim=1, stable=True)

    def global_order(flags):
        per_det = torch.zeros((Cp, B, K), dtype=det.dtype, device=dev) \
            .scatter_(-1, ord_b, flags.to(det.dtype))
        return torch.gather(per_det.reshape(Cp, B * K), 1, order)

    tp, fp = global_order(hits), global_order(fp_sorted)
    ctp = torch.cumsum(tp, 1)
    cfp = torch.cumsum(fp, 1)
    precision = ctp / torch.clamp_min(ctp + cfp, 1e-10)
    ap = (precision * tp).sum(1) / torch.clamp_min(n_gt, 1)
    aps = torch.where(n_gt > 0, ap, _full(ap, float('nan')))
    valid = ~torch.isnan(aps)
    mean_ap = torch.where(valid, aps, _full(aps, 0.0)).sum() \
        / torch.clamp_min(valid.sum(), 1)
    return {'MAP': mean_ap}
