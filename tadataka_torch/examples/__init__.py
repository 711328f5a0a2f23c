"""The JAX package's demo entry points (``examples/*.py``) on the port,
one module each, run as ``python -m tadataka_torch.examples.<name>``:
``semi_dense_vo``, ``dvo_trajectory``, ``feature_based_vo``,
``depth_from_stereo``, ``vitamin_e``, ``vitamin_e_vo`` and
``dense_triangulation``.  Each takes the JAX example's flags and prints
its records, plus ``--device`` (the card by default; ``--device cpu``
runs on the CPU), and has ``main(argv=None)``.
"""

from pathlib import Path

# Where the examples read the NewTsukuba fixture, inside this checkout;
# the repository does not hold it yet, and nothing fetches it.
NEW_TSUKUBA_FIXTURE = (Path(__file__).resolve().parents[2] / "tests"
                       / "dataset" / "new_tsukuba")


def add_device_flag(parser):
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default: cuda; "
                             "raises without a card)")
