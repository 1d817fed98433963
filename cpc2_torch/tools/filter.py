"""SNR/C50-based dataset filtering (counterpart of `cpc2_tpu/tools/filter.py`,
reference ``data/filter.py``; host code, the same flags, without pandas).

Given Brouhaha per-segment SNR and C50 predictions, build a joint score
table over the wav segments in ``<segments_dir>/no_filter``, then
materialize the top-p% subsets (by snr, c50, their normalized mean, or a
random draw) as symlink trees under
``<segments_dir>/<criterion>/<percentage>/``.

The table is a `Table` of numpy columns read and written with `csv`; its
CSV, the rows each criterion keeps and their order are those of the JAX
package's pandas tool on the same inputs: the ranking follows pandas'
single-column `sort_values` (numpy's quicksort on the reversed column,
reversed back), and the random draw pandas' `sample(frac=...)` (numpy's
global `choice` of `round(frac * n)` rows without replacement).

Run: ``python -m cpc2_torch.tools.filter <segments_dir> --table scores.csv``
or ``--create_pred_table <brouhaha_predictions_dir>``.
"""

from __future__ import annotations

import argparse
import csv
import logging
import math
import sys
from pathlib import Path
from typing import Dict, List, Sequence

import numpy as np

RAW_SUBSET = 'no_filter'
TABLE_NAME = 'brouhaha_snr_c50_scores.csv'
CRITERIA = ('snr', 'c50', 'snr_c50', 'random')


class Table:
    """Named columns of equal length, each a numpy array (numbers as int64
    or float64, anything else as objects), in their order."""

    def __init__(self, columns: Dict[str, Sequence]):
        self.columns = {name: _column(values)
                        for name, values in columns.items()}
        lengths = {len(v) for v in self.columns.values()}
        if len(lengths) > 1:
            raise ValueError(f"columns of lengths {sorted(lengths)}")

    def __len__(self) -> int:
        return len(next(iter(self.columns.values()))) if self.columns else 0

    def __getitem__(self, key):
        if isinstance(key, str):
            return self.columns[key]
        return Table({name: self.columns[name] for name in key})

    def __setitem__(self, name: str, values) -> None:
        self.columns[name] = _column(values)

    def take(self, rows) -> "Table":
        rows = np.asarray(rows, dtype=np.intp)
        return Table({name: v[rows] for name, v in self.columns.items()})

    def head(self, n: int) -> "Table":
        return self.take(np.arange(min(n, len(self))))

    def records(self):
        """Each row as a dict, in order."""
        names = list(self.columns)
        for i in range(len(self)):
            yield {name: self.columns[name][i] for name in names}

    def to_csv(self, path) -> None:
        with open(path, 'w', newline='') as f:
            out = csv.writer(f, lineterminator='\n')
            out.writerow(list(self.columns))
            for row in self.records():
                out.writerow([_cell(v) for v in row.values()])


def _column(values) -> np.ndarray:
    if isinstance(values, np.ndarray) and values.dtype.kind in 'ifO':
        return values
    values = list(values)
    if values and all(isinstance(v, (int, np.integer)) and
                      not isinstance(v, bool) for v in values):
        return np.asarray(values, dtype=np.int64)
    if values and all(isinstance(v, (int, float, np.number)) and
                      not isinstance(v, bool) for v in values):
        return np.asarray(values, dtype=np.float64)
    out = np.empty(len(values), dtype=object)
    out[:] = values
    return out


def _cell(value) -> str:
    """A value as pandas' `to_csv` writes it (NaN as an empty cell)."""
    if isinstance(value, (float, np.floating)):
        return '' if math.isnan(value) else repr(float(value))
    if isinstance(value, np.integer):
        return str(int(value))
    return str(value)


def _parse(tokens: List[str]) -> np.ndarray:
    """A column of text as pandas' `read_csv` types it: integers, else
    floats (an empty cell or `nan` is NaN), else the strings."""
    try:
        return np.asarray([int(t) for t in tokens], dtype=np.int64)
    except ValueError:
        pass
    try:
        return np.asarray([float(t) if t.strip() else math.nan
                           for t in tokens], dtype=np.float64)
    except ValueError:
        return _column(tokens)


def read_csv(path, sep: str = ',', names=None) -> Table:
    """A CSV file as a `Table`: its header row names the columns, unless
    `names` gives them (then every row is data)."""
    with open(path, newline='') as f:
        rows = [r for r in csv.reader(f, delimiter=sep) if r]
    if names is None:
        names, rows = rows[0], rows[1:]
    return Table({name: _parse([r[i] for r in rows])
                  for i, name in enumerate(names)})


def merge(left: Table, right: Table, on: str) -> Table:
    """The inner join of `left` and `right` on column `on`: the left rows in
    their order, each with every right row of its key in the right's
    order."""
    by_key: Dict = {}
    for j, key in enumerate(right[on]):
        by_key.setdefault(key, []).append(j)
    pairs = [(i, j) for i, key in enumerate(left[on])
             for j in by_key.get(key, [])]
    li = np.asarray([i for i, _ in pairs], dtype=np.intp)
    ri = np.asarray([j for _, j in pairs], dtype=np.intp)
    columns = {name: v[li] for name, v in left.columns.items()}
    columns.update({name: v[ri] for name, v in right.columns.items()
                    if name != on})
    return Table(columns)


def _read_brouhaha_scores(pred_dir: Path) -> Table:
    """One row per uri with raw `snr` and `c50` columns.

    Brouhaha emits two space-separated two-column files:
    ``mean_snr_labels.txt`` and ``reverb_labels.txt``.
    """
    def one(fname, value_col):
        return read_csv(pred_dir / fname, sep=' ', names=['uri', value_col])

    return merge(one('mean_snr_labels.txt', 'snr'),
                 one('reverb_labels.txt', 'c50'), on='uri')


def _index_wavs(raw_dir: Path) -> Table:
    """One row per segment wav: uri (stem), absolute path, and the path
    relative to the raw subset root (preserved in the symlink trees)."""
    paths = sorted(raw_dir.glob('**/*.wav'))
    return Table({'uri': [p.stem for p in paths], 'path': paths,
                  'subpath': [p.relative_to(raw_dir) for p in paths]})


def _unit_scale(values: np.ndarray) -> np.ndarray:
    """Min-max rescale to [0, 1] (constant input maps to 0)."""
    lo, hi = values.min(), values.max()
    span = hi - lo
    if span <= 0:
        span = 1e-12
    return (values - lo) / span


def create_snr_c50_table(segment_dir, pred_dir) -> Table:
    """Join Brouhaha scores with the on-disk segments and add normalized
    columns; persists the table as CSV next to the raw segments."""
    raw_dir = Path(segment_dir) / RAW_SUBSET
    scores = _read_brouhaha_scores(Path(pred_dir))
    wavs = _index_wavs(raw_dir)
    if len(wavs) != len(scores):
        raise ValueError(
            f"Number of predictions (= {len(scores)}) should be equal to "
            f"number of wav files (= {len(wavs)}).")

    table = merge(scores, wavs, on='uri')
    table['snr_normalized'] = _unit_scale(table['snr'])
    table['c50_normalized'] = _unit_scale(table['c50'])
    table['snr_c50'] = (table['snr_normalized'] + table['c50_normalized']) / 2
    table.to_csv(raw_dir / TABLE_NAME)
    return table


def _descending(values: np.ndarray) -> np.ndarray:
    """The row order of pandas' `sort_values(ascending=False)` on one
    column: NaN last, ties as its quicksort on the reversed column leaves
    them."""
    values = np.asarray(values)
    nan = (np.isnan(values) if values.dtype.kind == 'f'
           else np.zeros(len(values), bool))
    idx = np.arange(len(values))[~nan][::-1]
    order = idx[values[~nan][::-1].argsort(kind='quicksort')][::-1]
    return np.concatenate([order, np.nonzero(nan)[0]])


def filter_data(table: Table, criterion: str, percentage: int) -> Table:
    """The top ``percentage``% rows ranked by ``criterion`` (descending)."""
    keep = int(len(table) * percentage / 100)
    ranked = table.take(_descending(table[criterion]))
    return ranked.head(keep)[['uri', 'path', 'subpath']]


def randomly_filter_data(table: Table, criterion: str,
                         percentage: int) -> Table:
    """A uniform random ``percentage``% of the rows (criterion unused),
    drawn from numpy's global state."""
    del criterion
    size = round(percentage / 100 * len(table))
    rows = np.random.choice(len(table), size=size, replace=False)
    return table.take(rows)[['uri', 'path', 'subpath']]


def create_symlinks(files: Table, segments_dir, criterion: str,
                    percentage: int) -> None:
    """Mirror the selected segments as symlinks under
    ``<segments_dir>/<criterion>/<percentage>/<subpath>``."""
    subset_root = Path(segments_dir) / criterion / str(percentage)
    for rec in files.records():
        link = subset_root / rec['subpath']
        link.parent.mkdir(parents=True, exist_ok=True)
        link.symlink_to(rec['path'])


def _selector(criterion: str):
    return randomly_filter_data if criterion == 'random' else filter_data


def parse_args(argv):
    parser = argparse.ArgumentParser(
        description='Creates filtered subsets with the top X percents of '
                    'the dataset regarding to the desired criterion '
                    '(snr, c50 or both)')
    parser.add_argument('segments_dir', type=str,
                        help="Path to the audio segments")
    parser.add_argument('-p', '--percentage', type=int, nargs='+',
                        default=[10, 20, 30, 40, 50, 60, 70, 80, 90])
    parser.add_argument('-c', '--criterion', type=str, default="all",
                        choices=["snr", "c50", "snr_c50", "all", "random"])
    group = parser.add_mutually_exclusive_group(required=True)
    group.add_argument('--create_pred_table', metavar="PREDICTIONS_DIR")
    group.add_argument('--table', type=str)
    parser.add_argument("-v", "--verbose", action="store_true")
    return parser.parse_args(argv)


def main(argv):
    args = parse_args(argv)
    logging.getLogger().setLevel(
        logging.DEBUG if args.verbose else logging.INFO)

    if args.create_pred_table is not None:
        logging.info("Creating the table with snr and c50 scores")
        table = create_snr_c50_table(args.segments_dir,
                                     args.create_pred_table)
    else:
        table = read_csv(args.table)

    criteria = CRITERIA if args.criterion == 'all' else (args.criterion,)
    if args.criterion == 'all':
        logging.info(f"### Creating subsets for {args.percentage} "
                     f"regarding to snr, c50, both and random ###")
    for criterion in criteria:
        select = _selector(criterion)
        for percentage in args.percentage:
            create_symlinks(select(table, criterion, percentage),
                            args.segments_dir, criterion, percentage)
            logging.info(f"Subset of the {percentage} percents top of "
                         f"{criterion} done.")


if __name__ == "__main__":
    main(sys.argv[1:])
