"""2D GLS Navier-Stokes application."""

from .common import run_app


def main(argv=None) -> int:
    return run_app(2, argv)


if __name__ == "__main__":
    raise SystemExit(main())
