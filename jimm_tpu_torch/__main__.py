"""``python -m jimm_tpu_torch serve|train ...``

``aot``, ``cascade``, ``index`` and ``tune`` go to their own parsers, which
import torch only for ``aot warmup`` and ``tune run``: the host tools
(``aot ls|gc|verify``, ``cascade calibrate|ls``, ``index ...``, ``tune
ls``) then run without it."""

import sys

#: the commands whose parsers load torch only where a verb needs it
_HOST_TOOLS = {"aot": "jimm_tpu_torch.aot.cli",
               "cascade": "jimm_tpu_torch.serve.cascade.cli",
               "index": "jimm_tpu_torch.retrieval.cli",
               "tune": "jimm_tpu_torch.tune.cli"}


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in _HOST_TOOLS:
        import importlib
        return importlib.import_module(_HOST_TOOLS[argv[0]]).main(argv)
    from jimm_tpu_torch.cli import main as cli_main
    return cli_main(argv)


if __name__ == "__main__":
    raise SystemExit(main())
