from nimble_tpu_torch.quant.exact import (
    convert_rows_to_proper_umi,
    per_umi_thresholding,
    umi_intersection,
    intersect_lists,
    count_matrix,
    report_rows,
)

__all__ = [
    "convert_rows_to_proper_umi",
    "per_umi_thresholding",
    "umi_intersection",
    "intersect_lists",
    "count_matrix",
    "report_rows",
]
