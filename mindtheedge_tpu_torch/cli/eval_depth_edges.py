"""Edge AUC of predicted depth maps against GT edge maps (KITTI-DE,
DDAD-DE): counterpart of ``mindtheedge_tpu/cli/eval_depth_edges.py:1-50``
(reference root ``eval_depth_edges.py:377-416``), the same arguments and
prints::

    python -m mindtheedge_tpu_torch.cli.eval_depth_edges \\
        --depth_pred_list_path <txt> --depth_pred_dir_path <dir> \\
        [--depth_edge_gt_list_path <txt>] [--depth_edge_gt_dir_path <dir>] \\
        [--temp_save_path temp_output] [--num_workers 4]
"""

import argparse

import numpy as np

from mindtheedge_tpu_torch.evaluation.edge_auc import (
    mean_recall_at_precision_range, pr_evaluation)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Edge AUC from predicted depth maps vs GT edge maps.')
    parser.add_argument('--depth_pred_list_path', type=str, required=True,
                        help='List of predicted depth image names (.npy, metric depth)')
    parser.add_argument('--depth_pred_dir_path', type=str, required=True,
                        help='Directory containing the depth .npy files')
    parser.add_argument('--depth_edge_gt_list_path',
                        default='data/kitti_de/kitti_de_annotated_edges.txt')
    parser.add_argument('--depth_edge_gt_dir_path', default='data/kitti_de/gt')
    parser.add_argument('--temp_save_path', default='temp_output')
    parser.add_argument('--prec_recall_eval_range_min', default=0.12, type=float)
    parser.add_argument('--prec_recall_eval_range_max', default=0.65, type=float)
    parser.add_argument('--num_workers', default=4, type=int)
    args = parser.parse_args(argv)

    with open(args.depth_pred_list_path) as f:
        pred_list = [args.depth_pred_dir_path + '/' + x.strip().split('/')[-1]
                     for x in f if x.strip()]
    with open(args.depth_edge_gt_list_path) as f:
        gt_list = [args.depth_edge_gt_dir_path + '/' + x.strip().split('/')[-1]
                   for x in f if x.strip()]

    precision_vec, recall_vec = pr_evaluation(
        gt_list, pred_list, save_folder=args.temp_save_path,
        num_workers=args.num_workers)
    pr = np.vstack((precision_vec, recall_vec)).T

    f1 = mean_recall_at_precision_range(pr)
    f2 = mean_recall_at_precision_range(pr, args.prec_recall_eval_range_min,
                                        args.prec_recall_eval_range_max)
    print('AUC over all range: ' + str(f1) + '\n')
    print('AUC over partial range: ' + str(f2) + '\n')
    return f1, f2


if __name__ == '__main__':
    main()
