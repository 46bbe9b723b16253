"""Confusion-matrix result sets -> a LaTeX table with the best bolded
(``hypelcnn_tpu/utils/latex_table.py``).

Given one directory of confusion-matrix CSVs a method, a LaTeX results
table: per-class accuracies and OA/AA/kappa mean±std rows, every value tied
for a row's best in bold.

CLI: ``python -m hypelcnn_tpu_torch.utils.latex_table out.tex method1=dir1 method2=dir2 ...``
"""

from __future__ import annotations

import sys
from typing import Dict, List, Optional

import numpy as np

from hypelcnn_tpu_torch.utils.stat_extractor import (
    calculate_mean_std_metrics,
    extract_statistics_info,
    get_conf_list_from_directory,
)


def _fmt(mean: float, std: float, bold: bool, scale: float = 100.0) -> str:
    body = f"{mean * scale:.2f}$\\pm${std * scale:.2f}"
    return f"\\textbf{{{body}}}" if bold else body


def build_table(method_dirs: Dict[str, str],
                class_names: Optional[List[str]] = None) -> str:
    stats = {}
    for method, directory in method_dirs.items():
        conf_list = get_conf_list_from_directory(directory)
        if not conf_list:
            raise ValueError(f"No confusion CSVs found in {directory}")
        stats[method] = extract_statistics_info(conf_list)

    methods = list(stats.keys())
    n_classes = next(iter(stats.values())).aa_array.shape[1]
    if class_names is None:
        class_names = [f"Class {i}" for i in range(n_classes)]

    lines = []
    lines.append("\\begin{table}[htbp]")
    lines.append("\\centering")
    lines.append("\\caption{Classification results}")
    lines.append("\\begin{tabular}{l" + "c" * len(methods) + "}")
    lines.append("\\hline")
    lines.append("Class & " + " & ".join(methods) + " \\\\")
    lines.append("\\hline")

    # per-class rows: every tied maximum is bolded, not just the first
    per_class_mean = {m: np.mean(stats[m].aa_array, axis=0) for m in methods}
    per_class_std = {m: np.std(stats[m].aa_array, axis=0) for m in methods}
    for ci in range(n_classes):
        best = max(per_class_mean[m][ci] for m in methods)
        cells = [_fmt(per_class_mean[m][ci], per_class_std[m][ci],
                      per_class_mean[m][ci] == best)
                 for m in methods]
        lines.append(f"{class_names[ci]} & " + " & ".join(cells) + " \\\\")

    lines.append("\\hline")
    # aggregate rows; kappa is x100 too, as in the reference's tables
    agg = {m: calculate_mean_std_metrics(stats[m].oa_array, stats[m].aa_array,
                                         stats[m].kappa_array) for m in methods}
    for label, mean_idx, std_idx, scale in (("OA", 0, 1, 100.0), ("AA", 2, 3, 100.0),
                                            ("Kappa", 4, 5, 100.0)):
        best = max(agg[m][mean_idx] for m in methods)
        cells = [_fmt(agg[m][mean_idx], agg[m][std_idx],
                      agg[m][mean_idx] == best, scale)
                 for m in methods]
        lines.append(f"{label} & " + " & ".join(cells) + " \\\\")
    lines.append("\\hline")
    lines.append("\\end{tabular}")
    lines.append("\\end{table}")
    return "\n".join(lines)


def main() -> None:
    out_file = sys.argv[1]
    method_dirs = dict(arg.split("=", 1) for arg in sys.argv[2:])
    table = build_table(method_dirs)
    with open(out_file, "w", encoding="utf-8") as fid:
        fid.write(table + "\n")
    print(f"Wrote {out_file}")


if __name__ == "__main__":
    main()
