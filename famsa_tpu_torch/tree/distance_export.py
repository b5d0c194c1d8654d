"""Distance / PID matrix export to CSV.

Port of FAMSA src/tree/DistanceCalculator.cpp including the reference's
fast float formatter (utils/conversion.h Double2PChar with precision 6,
incl. its truncate-then-round representation)."""

import numpy as np

from ..core.params import DIST_PID
from ..ops.distance import run_distances


def format_double6(val: float) -> str:
    """NumericConversions::Double2PChar(val, 6, out)."""
    a = int(val)                                   # trunc toward zero
    b = int((1.0 + (val - float(a))) * 1e6 + 0.5)
    sb = str(b)
    sa = str(a)
    return sa + "." + sb[1:]


def export_distances(params, sequences):
    """Writes CSV to params.output_file_name; sequences in input order,
    padded to one length.  Rows come from the run's distance backend (K1
    on the torch backend, its rows sharded on the run's mesh if any; a
    prefix sweep of row blocks)."""
    measure = DIST_PID if params.calculate_pid else params.distance
    # distances: double transform stored as float32; PID: float transform
    inner_dtype = np.float32 if params.calculate_pid else np.float64
    be = run_distances(params, measure)(sequences, inner_dtype)

    n = len(sequences)
    square = params.generate_square_matrix

    with open(params.output_file_name, "w") as f:
        if square:
            for s in sequences:
                f.write("," + s.id[1:])
            f.write("\n")
        for row_id in range(n):
            count = n if square else row_id
            vals = be.row_prefix(row_id, count).astype(np.float32)
            name = sequences[row_id].id[1:]
            if count == 0:
                f.write(name + "\n")
            else:
                f.write(name + "," + ",".join(
                    format_double6(float(v)) for v in vals) + "\n")
