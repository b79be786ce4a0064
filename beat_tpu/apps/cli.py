"""
``beat-tpu`` command line interface.

Re-design of the reference ``beat`` app (``beat/apps/beat.py``): same
subcommand surface (init, import, update, clone, build_gfs, sample,
summarize, export, plot, check), argparse-based.  Subcommands are filled
in as the corresponding subsystems land.
"""

from __future__ import annotations

import argparse
import logging
import sys

logger = logging.getLogger("beat_tpu.cli")

SUBCOMMANDS = [
    "init", "import", "update", "clone", "build_gfs",
    "sample", "map", "summarize", "export", "plot", "check",
]


class _VersionAction(argparse.Action):
    def __call__(self, parser, *a, **kw):
        from beat_tpu.info import runtime_info

        print(runtime_info())
        parser.exit(0)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="beat-tpu",
        description="Bayesian earthquake-source inversion",
    )
    parser.add_argument("--version", nargs=0, action=_VersionAction,
                        help="framework + backend versions")
    sub = parser.add_subparsers(dest="command")

    from beat_tpu.apps import commands

    for name in SUBCOMMANDS:
        register = getattr(commands, f"register_{name}", None)
        if register is not None:
            register(sub)
    p = sub.add_parser("completions", help="print the bash completion script")
    p.set_defaults(handler=_cmd_completions)
    return parser


def _cmd_completions(args) -> int:
    from beat_tpu.apps.completion import completion_script

    print(completion_script())
    return 0


def main(argv=None) -> int:
    # persist compiled executables across invocations: a `beat-tpu
    # sample` rerun (resume, prior tweak) would otherwise recompile
    # every step program
    from beat_tpu.compile_cache import enable_persistent_compile_cache

    enable_persistent_compile_cache()
    parser = build_parser()
    args = parser.parse_args(argv)
    if args.command is None:
        parser.print_help()
        return 1
    handler = getattr(args, "handler", None)
    if handler is None:
        parser.error(f"subcommand {args.command} not yet implemented")
    logging.basicConfig(level=logging.INFO)
    try:
        return handler(args) or 0
    except (FileNotFoundError, ValueError, NotImplementedError) as e:
        print(f"beat-tpu {args.command}: {e}", file=sys.stderr)
        return 1


if __name__ == "__main__":
    sys.exit(main())
