"""Parameter template generator (reference:
applications/navier_stokes_parameter_template — SURVEY.md §2.3).
Prints a fully-commented default deck; must round-trip through the
parser."""

import sys

from ..core.parameters import declare_template


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    dim = int(argv[0]) if argv else 2
    print(declare_template(dim))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
