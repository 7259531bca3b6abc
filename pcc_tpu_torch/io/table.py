"""CSV tables in pandas' format, without pandas.

`write_csv` writes what pcc_tpu's eval CLIs write with
pandas.DataFrame(rows).to_csv(path): a first, unnamed column holding the
row index; a float column's values as their shortest repr ("inf" for
infinity) and NaN as an empty field; an integer column's values as
integers (a column holding any float is a float column, as in pandas).
"""

from __future__ import annotations

import csv
import math
import numbers


def _column(values) -> list[str]:
    if any(isinstance(v, numbers.Real) and not isinstance(v, numbers.Integral)
           for v in values):
        return ["" if math.isnan(float(v)) else repr(float(v)) for v in values]
    return [str(v) for v in values]


def write_csv(path: str, rows: dict) -> None:
    """rows: {column name: list of values}, every list as long."""
    cols = [_column(v) for v in rows.values()]
    n = len(cols[0]) if cols else 0
    with open(path, "w", newline="") as f:
        w = csv.writer(f, lineterminator="\n")
        w.writerow([""] + list(rows))
        for i in range(n):
            w.writerow([str(i)] + [c[i] for c in cols])
