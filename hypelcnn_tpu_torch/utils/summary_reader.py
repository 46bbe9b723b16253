"""Training-log scraping: confusion matrices and metric history to CSV
(``hypelcnn_tpu/utils/summary_reader.py``).

Collects a train CLI log dir's ``validation_confusion_<step>.csv`` files,
scrapes ``validation_confusion`` text tensors out of any TF event files
there (the reference's experiment logs; ``utils/tb_events.py``, no
TensorFlow), and writes ``history.jsonl`` as ``metrics_history.csv``.

CLI: ``python -m hypelcnn_tpu_torch.utils.summary_reader <log_dir> [output_dir]``
(or ``python -m hypelcnn_tpu_torch.utils.tb_events <event_dir> [step ...]``
for the reference reader's own surface).
"""

from __future__ import annotations

import csv
import glob
import json
import os
import shutil
import sys
from typing import Dict, List

from hypelcnn_tpu_torch.utils.tb_events import extract_confusions


def collect_confusions(log_dir: str, output_dir: str) -> List[str]:
    os.makedirs(output_dir, exist_ok=True)
    copied = []
    for fn in sorted(glob.glob(os.path.join(log_dir, "validation_confusion_*.csv"))):
        dst = os.path.join(output_dir, os.path.basename(fn))
        if os.path.abspath(fn) != os.path.abspath(dst):
            shutil.copyfile(fn, dst)
        copied.append(dst)
    return copied


def history_to_csv(history: List[Dict], output_file: str) -> None:
    keys: List[str] = []
    for rec in history:
        for k in rec:
            if k not in keys:
                keys.append(k)
    with open(output_file, "w", newline="", encoding="utf-8") as fid:
        writer = csv.DictWriter(fid, fieldnames=keys)
        writer.writeheader()
        for rec in history:
            writer.writerow(rec)


def process_log_dir(log_dir: str, output_dir: str | None = None) -> None:
    output_dir = output_dir or log_dir
    copied = collect_confusions(log_dir, output_dir)
    print(f"Collected {len(copied)} confusion matrices into {output_dir}")
    # TF event files in the same dir are scraped too, so the reference's
    # experiment logs migrate without tensorboard or tensorflow
    if glob.glob(os.path.join(log_dir, "event*")):
        scraped = extract_confusions(log_dir, output_dir=output_dir)
        print(f"Scraped {len(scraped)} confusion matrices from event files")
    history_path = os.path.join(log_dir, "history.jsonl")
    if os.path.exists(history_path):
        with open(history_path, "r", encoding="utf-8") as fid:
            history = [json.loads(line) for line in fid if line.strip()]
        out = os.path.join(output_dir, "metrics_history.csv")
        history_to_csv(history, out)
        print(f"Wrote {out} ({len(history)} records)")


def main() -> None:
    log_dir = sys.argv[1]
    output_dir = sys.argv[2] if len(sys.argv) > 2 else None
    process_log_dir(log_dir, output_dir)


if __name__ == "__main__":
    main()
