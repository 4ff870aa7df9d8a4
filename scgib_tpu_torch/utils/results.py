"""Results records: a copy of ``scgib_tpu/utils/results.py``.

``update_evaluation_value`` is the reference's Excel updater
(script_classification.py:57-68): Mean / Variant / Best_epoch cells keyed
by the dataset's row.  It imports pandas inside the function, so the
module imports without it; a machine without pandas cannot write a sheet
(``finetune --xlsx``) and keeps the JSONL journal (``append_result``,
``finetune --journal``) instead.
"""

from __future__ import annotations

import json
import os
import time
from typing import Any, Dict, Optional


def update_evaluation_value(file_path: str, dataset: str, column: str,
                            value: Any, sheet: str = "results") -> str:
    """Set one cell (row=dataset, col=column) in an Excel workbook,
    creating file/row/column as needed — the reference's updater with the
    bootstrap it lacks.  If no Excel engine (openpyxl) is installed the
    table is kept as a CSV sibling instead; returns the path written."""
    import pandas as pd

    csv_path = os.path.splitext(file_path)[0] + ".csv"
    if os.path.exists(file_path):
        try:
            df = pd.read_excel(file_path, index_col=0)
        except ImportError:
            df = pd.read_csv(csv_path, index_col=0) if \
                os.path.exists(csv_path) else pd.DataFrame()
    elif os.path.exists(csv_path):
        df = pd.read_csv(csv_path, index_col=0)
    else:
        df = pd.DataFrame()
    if column not in df.columns:
        df[column] = pd.Series(dtype=object)
    df.loc[dataset, column] = value
    try:
        tmp = file_path + ".tmp.xlsx"
        df.to_excel(tmp, sheet_name=sheet)
        os.replace(tmp, file_path)
        return file_path
    except (ImportError, ModuleNotFoundError):
        tmp = csv_path + ".tmp"
        df.to_csv(tmp)
        os.replace(tmp, csv_path)
        return csv_path


def append_result(journal_path: str, record: Dict[str, Any]) -> None:
    """Append one result record (with timestamp) to a JSONL journal."""
    rec = dict(record)
    rec.setdefault("ts", time.time())
    os.makedirs(os.path.dirname(os.path.abspath(journal_path)),
                exist_ok=True)
    with open(journal_path, "a") as f:
        f.write(json.dumps(rec, default=str) + "\n")
