"""CLI entry point: ``python -m repro_torch.lint [paths...] [--json] [--fix]
[--self-test] [--root DIR]``.

Exit codes: 0 clean, 1 unsuppressed findings (or self-test failure),
2 usage errors.  ``--fix`` applies the mechanical fixes (TL000 reason
normalization) and re-lints, so the exit code reflects the post-fix state.
"""
from __future__ import annotations

import argparse
import pathlib
import sys

from . import engine

DEFAULT_PATHS = ["src/repro_torch", "chip_smoke.py", "tools",
                 "tests/test_torch_*.py"]
CORPUS = ("tests", "lint_corpus", "torch")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.lint",
        description="tracelint for the port: host syncs in the captured "
                    "round, generators, config classification, DIAG_KEYS, "
                    "the kernels' accumulation and spills")
    parser.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                        help="files, directories or globs to lint (default: "
                             + " ".join(DEFAULT_PATHS) + ")")
    parser.add_argument("--json", action="store_true",
                        help="machine-readable report on stdout")
    parser.add_argument("--fix", action="store_true",
                        help="apply mechanical fixes in place, then re-lint")
    parser.add_argument("--self-test", action="store_true",
                        help="run every rule against tests/lint_corpus/torch/ "
                             "and exit nonzero if any rule misses its fixture")
    parser.add_argument("--root", default=".",
                        help="repo root for relative paths (default: cwd)")
    args = parser.parse_args(argv)

    root = pathlib.Path(args.root).resolve()

    if args.self_test:
        corpus = root.joinpath(*CORPUS)
        if not corpus.is_dir():
            print(f"tracelint: corpus directory not found: {corpus}",
                  file=sys.stderr)
            return 2
        ok, report = engine.self_test(corpus, root)
        print(report)
        return 0 if ok else 1

    project, active, suppressed = engine.lint(args.paths, root=root)
    if args.fix:
        touched = engine.apply_fixes(project, active)
        if touched:
            print(f"tracelint: fixed {len(touched)} file(s): "
                  f"{', '.join(touched)}", file=sys.stderr)
        project, active, suppressed = engine.lint(args.paths, root=root)

    n_files = engine.n_files(project)
    if args.json:
        print(engine.render_json(active, suppressed, n_files,
                                 project.ptxas_read))
    else:
        print(engine.render_human(active, suppressed, n_files))
    return 1 if active else 0


if __name__ == "__main__":
    sys.exit(main())
