"""Helpers of the driver parity tests: the port's drivers and the JAX
package's write their CSVs as the same text, so the tests hold them
together cell by cell."""

import csv
import os

import numpy as np


def rows(path):
    with open(path) as fh:
        return list(csv.reader(fh))


def _is_num(x):
    try:
        float(x)
        return True
    except ValueError:
        return False


def assert_csv_close(got_path, want_rows, rtol):
    """The CSV at ``got_path`` has ``want_rows``' header, row count and
    text cells, and its numbers lie within relative ``rtol`` of theirs
    (NaN where they have NaN)."""
    got = rows(got_path)
    assert got[0] == [str(h) for h in want_rows[0]], got_path
    assert len(got) == len(want_rows), got_path
    for g, w in zip(got[1:], want_rows[1:]):
        assert [x for x in g if not _is_num(x)] == \
            [str(x) for x in w if not _is_num(x)], got_path
        np.testing.assert_allclose([float(x) for x in g if _is_num(x)],
                                   [float(x) for x in w if _is_num(x)],
                                   rtol=rtol, atol=1e-300, err_msg=got_path)


def assert_same_csvs(got_dir, want_dir, names, rtol):
    """Each ``<name>.csv`` of ``names`` in ``got_dir`` matches the one in
    ``want_dir`` (see :func:`assert_csv_close`)."""
    for name in names:
        assert_csv_close(os.path.join(got_dir, f"{name}.csv"),
                         rows(os.path.join(want_dir, f"{name}.csv")), rtol)


_FIRST = {}


def once_per_extract(run_ensemble):
    """The JAX package's ``run_ensemble``, handed the first function seen
    for each ``extract`` source line.  Its drivers build a fresh lambda
    in each loop pass, and its compiled solvers are cached by the
    extract function's identity; a lambda of one line that closes over
    nothing computes the same thing each time, so reusing the first one
    changes no number and compiles each program once."""
    def run(*args, extract, **kw):
        if extract.__closure__ is None:
            extract = _FIRST.setdefault(extract.__code__, extract)
        return run_ensemble(*args, extract=extract, **kw)
    return run
