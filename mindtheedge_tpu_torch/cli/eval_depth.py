"""Depth metrics of predicted depth maps against GT, from three lists:
counterpart of ``mindtheedge_tpu/cli/eval_depth.py:1-44`` (reference root
``eval_depth.py`` run as a script)::

    python -m mindtheedge_tpu_torch.cli.eval_depth --image_list <txt> \\
        --gt_list <txt> --pred_list <txt> [--gt_crop x0 x1 y0 y1] \\
        [--median_scaling none|median] [--out_dir analysis_output]

Writes ``<out_dir>/analyzer_data.pkl`` and
``<out_dir>/mean_frames_depth_metrics.csv`` and prints the mean of each
column, as the JAX CLI does; it needs no pandas.
"""

import argparse
import os


def main(argv=None):
    parser = argparse.ArgumentParser(description='Depth metric analyzer')
    parser.add_argument('--image_list', type=str, required=True)
    parser.add_argument('--gt_list', type=str, required=True)
    parser.add_argument('--pred_list', type=str, required=True)
    parser.add_argument('--min_depth', type=float, default=0.01)
    parser.add_argument('--max_depth', type=float, default=80.0)
    parser.add_argument('--gt_crop', type=int, nargs=4,
                        default=[44, 1197, 153, 371])
    parser.add_argument('--median_scaling', type=str, default='none')
    parser.add_argument('--out_dir', type=str, default='analysis_output')
    args = parser.parse_args(argv)

    from mindtheedge_tpu_torch.config.node import ConfigNode
    from mindtheedge_tpu_torch.evaluation.depth_analyzer import (
        DensePredictionAnalyzer, DepthEvalLoader, column_means, write_mean_csv)

    cfg = ConfigNode({
        'min_depth': args.min_depth, 'max_depth': args.max_depth,
        'gt_crop': args.gt_crop, 'median_scaling': args.median_scaling,
        'eval_mask_image_list': ''})
    loader = DepthEvalLoader(args.image_list, args.gt_list, args.pred_list)
    analyzer = DensePredictionAnalyzer(cfg)
    for i in range(len(loader)):
        _, gt, d = loader[i]
        analyzer.eval_frame(i, gt, d)
    analyzer.save_results(args.out_dir, 'analyzer_data.pkl')
    csv_path = os.path.join(args.out_dir, 'mean_frames_depth_metrics.csv')
    write_mean_csv(analyzer.per_frm_res, csv_path)
    means = column_means(analyzer.per_frm_res)
    width = max(len(name) for name, _ in means)
    for name, value in means:
        print(f'{name:<{width}}  {value!r}')
    print(f'-> {csv_path}')


if __name__ == '__main__':
    main()
