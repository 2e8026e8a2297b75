"""Result tabulation: summary rows → LaTeX + PNG tables
(role of reference `fs3dgs_benchmark/bench_tables.py:11-478`).

Per-metric tables (PSNR↑/SSIM↑/LPIPS↓/duration) with scenes as rows and
models as columns, aggregated mean±std over seeds; a combined LaTeX file; PNG
renderings via matplotlib for quick inspection.

The port's copy of `sparse_view_3dgs_pack_tpu/benchmark/bench_tables.py`
(host only; `tests/test_torch_harness.py` holds its LaTeX byte for byte).
"""

from __future__ import annotations

import os
from collections import defaultdict
from pathlib import Path

import numpy as np

METRICS = [("psnr", "PSNR $\\uparrow$", "max"),
           ("ssim", "SSIM $\\uparrow$", "max"),
           ("lpips", "LPIPS $\\downarrow$", "min"),
           ("duration_sec", "Train time (s) $\\downarrow$", "min")]


class BenchTables:
    def __init__(self, summary_rows):
        self.rows = summary_rows

    def _lpips_title_suffix(self):
        """Make proxy LPIPS impossible to mistake for the published metric:
        any row computed without converted VGG16 weights retitles the LPIPS
        table."""
        backends = {r.get("lpips_backend") for r in self.rows
                    if r.get("lpips_backend")}
        proxies = {b for b in backends if b and "vgg" not in str(b).lower()}
        if proxies:
            return " (PROXY backend: " + ", ".join(sorted(proxies)) + \
                   " — not comparable to published LPIPS)"
        return ""

    def _metrics(self):
        """Active metric columns: the static set, plus a clearly-labelled
        LPIPS-proxy table only when some run used the random-feature
        fallback (never mixed into the real LPIPS column)."""
        ms = list(METRICS)
        if any(r.get("lpips_proxy") is not None for r in self.rows):
            ms.insert(3, ("lpips_proxy",
                          "LPIPS-proxy (random features — NOT comparable "
                          "to published LPIPS) $\\downarrow$", "min"))
        return ms

    def aggregate(self):
        """→ {metric: {scene: {model: (mean, std, n)}}}"""
        ms = self._metrics()
        agg = {m: defaultdict(dict) for m, _, _ in ms}
        buckets = defaultdict(list)
        for row in self.rows:
            for metric, _, _ in ms:
                v = row.get(metric)
                if v is not None:
                    buckets[(metric, row["scene"], row["model"])].append(
                        float(v))
        for (metric, scene, model), vals in buckets.items():
            agg[metric][scene][model] = (float(np.mean(vals)),
                                         float(np.std(vals)), len(vals))
        return agg

    def _models_scenes(self):
        models = sorted({r["model"] for r in self.rows})
        scenes = sorted({r["scene"] for r in self.rows})
        return models, scenes

    def _latex_table(self, metric, title, best):
        models, scenes = self._models_scenes()
        agg = self.aggregate()[metric]
        lines = ["\\begin{table}[h]", "\\centering",
                 f"\\caption{{{title}}}",
                 "\\begin{tabular}{l" + "c" * len(models) + "}",
                 "\\toprule",
                 "Scene & " + " & ".join(models) + " \\\\", "\\midrule"]
        for scene in scenes:
            cells = []
            vals = {m: agg.get(scene, {}).get(m) for m in models}
            present = {m: v[0] for m, v in vals.items() if v}
            best_val = (max(present.values()) if best == "max"
                        else min(present.values())) if present else None
            for m in models:
                v = vals.get(m)
                if v is None:
                    cells.append("--")
                else:
                    mean, std, n = v
                    cell = f"{mean:.3f}"
                    if n > 1:
                        cell += f" $\\pm$ {std:.3f}"
                    if best_val is not None and abs(mean - best_val) < 1e-9:
                        cell = "\\textbf{" + cell + "}"
                    cells.append(cell)
            lines.append(scene + " & " + " & ".join(cells) + " \\\\")
        lines += ["\\bottomrule", "\\end{tabular}", "\\end{table}"]
        return "\n".join(lines)

    def _png_table(self, metric, title, path):
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        models, scenes = self._models_scenes()
        agg = self.aggregate()[metric]
        cell_text = []
        for scene in scenes:
            row = []
            for m in models:
                v = agg.get(scene, {}).get(m)
                row.append("--" if v is None else f"{v[0]:.3f}")
            cell_text.append(row)
        fig, ax = plt.subplots(figsize=(1.5 + len(models) * 1.2,
                                        0.7 + len(scenes) * 0.4))
        ax.axis("off")
        table = ax.table(cellText=cell_text, rowLabels=scenes,
                         colLabels=models, loc="center")
        table.scale(1, 1.4)
        ax.set_title(title.replace("$\\uparrow$", "↑")
                     .replace("$\\downarrow$", "↓"))
        fig.tight_layout()
        fig.savefig(path, dpi=150)
        plt.close(fig)

    def export(self, out_root) -> Path:
        tables_dir = Path(out_root) / "tables"
        tables_dir.mkdir(parents=True, exist_ok=True)
        combined = []
        for metric, title, best in self._metrics():
            if metric == "lpips":
                title = title + self._lpips_title_suffix()
            tex = self._latex_table(metric, title, best)
            (tables_dir / f"{metric}.tex").write_text(tex)
            combined.append(tex)
            try:
                self._png_table(metric, title,
                                tables_dir / f"{metric}.png")
            except Exception:
                pass
        (tables_dir / "combined.tex").write_text("\n\n".join(combined))
        return tables_dir
