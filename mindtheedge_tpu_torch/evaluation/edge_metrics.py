"""In-training validation edge metrics: counterpart of
``mindtheedge_tpu/evaluation/edge_metrics.py`` (reference
``model_wrapper.py:376-442``).  Host-side: the predicted depth goes through
cv2 Canny at (10,20)/(20,40)/(30,60), or a DEE probability through
thresholds 0.5/0.75/0.9, then bidirectional chamfer precision, recall and
F1 against the GT edges."""

import numpy as np

from mindtheedge_tpu_torch.evaluation.chamfer import chamfer_distance

EDGE_METRIC_NAMES = ('precision_1', 'recall_1', 'f1_1',
                     'precision_2', 'recall_2', 'f1_2',
                     'precision_3', 'recall_3', 'f1_3')


def compute_edge_metrics(pred, gt_edge, is_probability=False, gt_crop=None):
    """pred: [H,W] metric depth (or edge probability); gt_edge: [H,W] in
    [0,1] -> the 9 chamfer metrics (3 thresholds x P/R/F1)."""
    import cv2
    gt = np.asarray(gt_edge).squeeze() * 255
    pred = np.asarray(pred).squeeze()
    if pred.shape != gt.shape:
        pred = cv2.resize(pred, (gt.shape[1], gt.shape[0]),
                          interpolation=cv2.INTER_LINEAR)

    if not is_probability:
        vis = (pred * (255.0 / max(pred.max(), 1e-12))).astype(np.uint8)
        edge_images = [cv2.Canny(vis, 10, 20), cv2.Canny(vis, 20, 40),
                       cv2.Canny(vis, 30, 60)]
    else:
        edge_images = [(pred > t).astype('uint8') * 255 for t in (0.5, 0.75, 0.9)]

    if gt_crop:
        gt = gt[gt_crop[2]:gt_crop[3], gt_crop[0]:gt_crop[1]]

    out = []
    for edge_im in edge_images:
        if gt_crop:
            edge_im = edge_im[gt_crop[2]:gt_crop[3], gt_crop[0]:gt_crop[1]]
        _, precision, _ = chamfer_distance(edge_im, gt)
        _, recall, _ = chamfer_distance(gt, edge_im)
        f1 = 2 * (precision * recall) / max(precision + recall, 1e-12)
        out.extend([precision, recall, f1])
    return out
