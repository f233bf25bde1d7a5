"""3D grad-div Taylor-Hood Navier-Stokes application."""

from .common import run_app


def main(argv=None) -> int:
    return run_app(3, argv, solver="gd")


if __name__ == "__main__":
    raise SystemExit(main())
