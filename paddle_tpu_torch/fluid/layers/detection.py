"""Detection layers (SSD family). Parity: reference layers/detection.py
and the JAX package's fluid/layers/detection.py, layer for layer (their
rules: ops_impl/detection_ops.py). Integer outputs are declared int64 (the
port's index dtype; int32 in JAX). Departure: detection_output passes
scores_layout='BMC' to its multiclass_nms, whose Scores are the softmax
over the classes of [B, M, C] confidences; the JAX layer omits it, and its
rule then reads the priors as classes (labels past C where M != C).
"""
import numpy as np

from ..layer_helper import LayerHelper
from . import nn
from . import tensor as tensor_mod

__all__ = [
    'prior_box', 'multi_box_head', 'bipartite_match', 'target_assign',
    'detection_output', 'ssd_loss', 'detection_map', 'rpn_target_assign',
    'anchor_generator', 'box_coder', 'iou_similarity',
]


def prior_box(input, image, min_sizes, max_sizes=None, aspect_ratios=[1.],
              variance=[0.1, 0.1, 0.2, 0.2], flip=False, clip=False,
              steps=[0.0, 0.0], offset=0.5, name=None):
    """reference layers/detection.py:prior_box."""
    helper = LayerHelper("prior_box", **locals())
    dtype = helper.input_dtype()
    box = helper.create_variable_for_type_inference(dtype)
    var = helper.create_variable_for_type_inference(dtype)
    if not isinstance(min_sizes, (list, tuple)):
        min_sizes = [min_sizes]
    attrs = {'min_sizes': [float(m) for m in min_sizes],
             'aspect_ratios': [float(a) for a in aspect_ratios],
             'variances': [float(v) for v in variance],
             'flip': flip, 'clip': clip,
             'step_w': float(steps[0]), 'step_h': float(steps[1]),
             'offset': offset}
    if max_sizes is not None and len(max_sizes) > 0 and max_sizes[0] > 0:
        if not isinstance(max_sizes, (list, tuple)):
            max_sizes = [max_sizes]
        attrs['max_sizes'] = [float(m) for m in max_sizes]
    helper.append_op(type="prior_box",
                     inputs={"Input": input, "Image": image},
                     outputs={"Boxes": box, "Variances": var}, attrs=attrs)
    box.stop_gradient = True
    var.stop_gradient = True
    return box, var


def box_coder(prior_box, prior_box_var, target_box,
              code_type="encode_center_size", box_normalized=True, name=None):
    helper = LayerHelper("box_coder", **locals())
    output_box = helper.create_variable_for_type_inference(prior_box.dtype)
    helper.append_op(type="box_coder",
                     inputs={"PriorBox": prior_box,
                             "PriorBoxVar": prior_box_var,
                             "TargetBox": target_box},
                     attrs={"code_type": code_type,
                            "box_normalized": box_normalized},
                     outputs={"OutputBox": output_box})
    return output_box


def multi_box_head(inputs, image, base_size, num_classes, aspect_ratios,
                   min_ratio=None, max_ratio=None, min_sizes=None,
                   max_sizes=None, steps=None, step_w=None, step_h=None,
                   offset=0.5, variance=[0.1, 0.1, 0.2, 0.2], flip=True,
                   clip=False, kernel_size=1, pad=0, stride=1, name=None,
                   min_max_aspect_ratios_order=False):
    """SSD head over multiple feature maps (reference
    layers/detection.py:multi_box_head)."""
    def _reshape_with_axis_(input, axis=1):
        return nn.flatten(input, axis=axis)

    def _is_list_or_tuple_(data):
        return isinstance(data, (list, tuple))

    if not _is_list_or_tuple_(inputs):
        raise ValueError('inputs should be a list of Variables')
    if min_sizes is None:
        num_layer = len(inputs)
        assert num_layer >= 2
        min_sizes = []
        max_sizes = []
        # with 2 maps there is no interpolation range (the reference
        # derivation divides by num_layer-2); one ratio step covers it
        step = (int(np.floor((max_ratio - min_ratio) / (num_layer - 2)))
                if num_layer > 2 else (max_ratio - min_ratio + 1))
        for ratio in range(min_ratio, max_ratio + 1, step):
            min_sizes.append(base_size * ratio / 100.)
            max_sizes.append(base_size * (ratio + step) / 100.)
        min_sizes = [base_size * .10] + min_sizes
        max_sizes = [base_size * .20] + max_sizes

    locs, confs, boxes_list, vars_list = [], [], [], []
    for i, input in enumerate(inputs):
        min_size = min_sizes[i]
        max_size = max_sizes[i] if max_sizes else []
        if not _is_list_or_tuple_(min_size):
            min_size = [min_size]
        if not _is_list_or_tuple_(max_size):
            max_size = [max_size] if max_size else []
        aspect_ratio = aspect_ratios[i]
        if not _is_list_or_tuple_(aspect_ratio):
            aspect_ratio = [aspect_ratio]
        step = [step_w[i] if step_w else 0.0,
                step_h[i] if step_h else 0.0] if (step_w or step_h) else \
            (steps[i] if steps else [0.0, 0.0])
        box, var = prior_box(input, image, min_size, max_size, aspect_ratio,
                             variance, flip, clip, step, offset)
        boxes_list.append(box)
        vars_list.append(var)
        num_boxes = box.shape[2]
        num_loc_output = num_boxes * 4
        mbox_loc = nn.conv2d(input=input, num_filters=num_loc_output,
                             filter_size=kernel_size, padding=pad,
                             stride=stride)
        mbox_loc = nn.transpose(mbox_loc, perm=[0, 2, 3, 1])
        mbox_loc_flatten = nn.flatten(mbox_loc, axis=1)
        locs.append(mbox_loc_flatten)
        num_conf_output = num_boxes * num_classes
        conf_loc = nn.conv2d(input=input, num_filters=num_conf_output,
                             filter_size=kernel_size, padding=pad,
                             stride=stride)
        conf_loc = nn.transpose(conf_loc, perm=[0, 2, 3, 1])
        conf_loc_flatten = nn.flatten(conf_loc, axis=1)
        confs.append(conf_loc_flatten)

    mbox_locs_concat = tensor_mod.concat(locs, axis=1)
    mbox_locs_concat = nn.reshape(mbox_locs_concat, shape=[0, -1, 4])
    mbox_confs_concat = tensor_mod.concat(confs, axis=1)
    mbox_confs_concat = nn.reshape(mbox_confs_concat,
                                   shape=[0, -1, num_classes])
    boxes_flat = [nn.reshape(b, shape=[-1, 4]) for b in boxes_list]
    vars_flat = [nn.reshape(v, shape=[-1, 4]) for v in vars_list]
    box = tensor_mod.concat(boxes_flat)
    var = tensor_mod.concat(vars_flat)
    box.stop_gradient = True
    var.stop_gradient = True
    return mbox_locs_concat, mbox_confs_concat, box, var


def bipartite_match(dist_matrix, match_type=None, dist_threshold=None,
                    name=None):
    helper = LayerHelper('bipartite_match', **locals())
    match_indices = helper.create_variable_for_type_inference('int64')
    match_distance = helper.create_variable_for_type_inference(
        dist_matrix.dtype)
    helper.append_op(
        type='bipartite_match', inputs={'DistMat': dist_matrix},
        attrs={'match_type': match_type or 'bipartite',
               'dist_threshold': dist_threshold or 0.5},
        outputs={'ColToRowMatchIndices': match_indices,
                 'ColToRowMatchDist': match_distance})
    return match_indices, match_distance


def target_assign(input, matched_indices, negative_indices=None,
                  mismatch_value=None, name=None):
    helper = LayerHelper('target_assign', **locals())
    out = helper.create_variable_for_type_inference(input.dtype)
    out_weight = helper.create_variable_for_type_inference('float32')
    helper.append_op(
        type='target_assign',
        inputs={'X': input, 'MatchIndices': matched_indices},
        attrs={'mismatch_value': mismatch_value},
        outputs={'Out': out, 'OutWeight': out_weight})
    return out, out_weight


def detection_output(loc, scores, prior_box, prior_box_var,
                     background_label=0, nms_threshold=0.3, nms_top_k=400,
                     keep_top_k=200, score_threshold=0.01, nms_eta=1.0):
    """Decode + class NMS (reference layers/detection.py:detection_output):
    a fixed [B, keep_top_k, 6] block a batch (label, score, box), padded
    with label -1 rows. The softmaxed scores are [B, M, C]: the op says so
    (scores_layout='BMC')."""
    helper = LayerHelper("detection_output", **locals())
    decoded_box = box_coder(prior_box=prior_box, prior_box_var=prior_box_var,
                            target_box=loc, code_type='decode_center_size')
    scores = nn.softmax(input=scores)
    nmsed_outs = helper.create_variable_for_type_inference('float32')
    helper.append_op(
        type="multiclass_nms",
        inputs={'Scores': scores, 'BBoxes': decoded_box},
        outputs={'Out': nmsed_outs},
        attrs={'background_label': background_label,
               'nms_threshold': nms_threshold, 'nms_top_k': nms_top_k,
               'keep_top_k': keep_top_k, 'score_threshold': score_threshold,
               'nms_eta': nms_eta, 'scores_layout': 'BMC'})
    nmsed_outs.stop_gradient = True
    return nmsed_outs


def iou_similarity(x, y, name=None):
    """reference layers/detection.py:iou_similarity."""
    helper = LayerHelper("iou_similarity", **locals())
    out = helper.create_variable_for_type_inference(dtype=x.dtype)
    helper.append_op(type="iou_similarity", inputs={"X": [x], "Y": [y]},
                     outputs={"Out": [out]})
    return out


def ssd_loss(location, confidence, gt_box, gt_label, prior_box,
             prior_box_var=None, background_label=0, overlap_threshold=0.5,
             neg_pos_ratio=3.0, neg_overlap=0.5, loc_loss_weight=1.0,
             conf_loss_weight=1.0, match_type='per_prediction',
             mining_type='max_negative', normalize=True,
             sample_size=None):
    """reference layers/detection.py:ssd_loss:562.

    The reference composes 13 ops (iou_similarity,
    bipartite_match, target_assign x3, mine_hard_examples, ...); here ONE
    fused dense op does matching, smooth-L1 localization loss, softmax
    confidence loss and max-negative mining (ops_impl/detection_ops.py).
    Returns the per-image loss [N, 1] (prior-summed, normalized by the
    batch-global positive count) matching the reference's output shape.
    """
    if mining_type != 'max_negative':
        raise ValueError("only mining_type='max_negative' is supported "
                         "(the reference's default)")
    helper = LayerHelper('ssd_loss', **locals())
    loss = helper.create_variable_for_type_inference('float32')
    inputs = {'Loc': [location], 'Conf': [confidence], 'GtBox': [gt_box],
              'GtLabel': [gt_label], 'PriorBox': [prior_box]}
    if prior_box_var is not None:
        inputs['PriorBoxVar'] = [prior_box_var]
    helper.append_op(
        type='ssd_loss', inputs=inputs, outputs={'Loss': [loss]},
        attrs={'background_label': background_label,
               'overlap_threshold': overlap_threshold,
               'neg_pos_ratio': neg_pos_ratio,
               'neg_overlap': neg_overlap,
               'loc_loss_weight': loc_loss_weight,
               'conf_loss_weight': conf_loss_weight,
               'match_type': match_type, 'normalize': normalize},
        infer_shape=False)
    loss.shape = (location.shape[0], 1)
    return loss


def detection_map(detect_res, label, class_num, background_label=0,
                  overlap_threshold=0.3, evaluate_difficult=True,
                  has_state=None, input_states=None, out_states=None,
                  ap_version='integral'):
    """reference layers/detection.py:detection_map:299 (integral AP).
    Stateless per-batch mAP over the dense NMS output."""
    helper = LayerHelper('detection_map', **locals())
    map_out = helper.create_variable_for_type_inference('float32')
    helper.append_op(
        type='detection_map',
        inputs={'DetectRes': [detect_res], 'Label': [label]},
        outputs={'MAP': [map_out]},
        attrs={'class_num': class_num,
               'background_label': background_label,
               'overlap_threshold': overlap_threshold,
               'evaluate_difficult': evaluate_difficult,
               'ap_type': ap_version},
        infer_shape=False)
    map_out.shape = ()
    map_out.stop_gradient = True
    return map_out


def rpn_target_assign(loc, scores, anchor_box, gt_box,
                      rpn_batch_size_per_im=256, fg_fraction=0.25,
                      rpn_positive_overlap=0.7, rpn_negative_overlap=0.3):
    """reference layers/detection.py:rpn_target_assign:56.

    Dense form: exactly rpn_batch_size_per_im samples per image
    (target label -1 marks unused slots) instead of the reference's
    variable-length gathered index lists.
    """
    helper = LayerHelper('rpn_target_assign', **locals())
    pred_score = helper.create_variable_for_type_inference(scores.dtype)
    pred_loc = helper.create_variable_for_type_inference(loc.dtype)
    tgt_lbl = helper.create_variable_for_type_inference('int64')
    tgt_box = helper.create_variable_for_type_inference(loc.dtype)
    helper.append_op(
        type='rpn_target_assign',
        inputs={'Loc': [loc], 'Score': [scores], 'AnchorBox': [anchor_box],
                'GtBox': [gt_box]},
        outputs={'PredScore': [pred_score], 'PredLoc': [pred_loc],
                 'TargetLabel': [tgt_lbl], 'TargetBox': [tgt_box]},
        attrs={'rpn_batch_size_per_im': rpn_batch_size_per_im,
               'fg_fraction': fg_fraction,
               'rpn_positive_overlap': rpn_positive_overlap,
               'rpn_negative_overlap': rpn_negative_overlap},
        infer_shape=False)
    S = int(rpn_batch_size_per_im)
    pred_score.shape = (loc.shape[0], S, 1)
    pred_loc.shape = (loc.shape[0], S, 4)
    tgt_lbl.shape = (loc.shape[0], S, 1)
    tgt_box.shape = (loc.shape[0], S, 4)
    return pred_score, pred_loc, tgt_lbl, tgt_box


def anchor_generator(input, anchor_sizes=None, aspect_ratios=None,
                     variance=[0.1, 0.1, 0.2, 0.2], stride=None, offset=0.5,
                     name=None):
    helper = LayerHelper("anchor_generator", **locals())
    dtype = helper.input_dtype()
    anchor = helper.create_variable_for_type_inference(dtype)
    var = helper.create_variable_for_type_inference(dtype)
    helper.append_op(
        type="anchor_generator", inputs={"Input": input},
        outputs={"Anchors": anchor, "Variances": var},
        attrs={'anchor_sizes': [float(a) for a in (anchor_sizes or [64.])],
               'aspect_ratios': [float(a) for a in (aspect_ratios or [1.])],
               'variances': [float(v) for v in variance],
               'stride': [float(s) for s in (stride or [16., 16.])],
               'offset': offset})
    anchor.stop_gradient = True
    var.stop_gradient = True
    return anchor, var
