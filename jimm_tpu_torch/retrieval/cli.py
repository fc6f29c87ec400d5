"""``python -m jimm_tpu_torch index``: manage retrieval vector stores from
the shell; the counterpart of ``jimm_tpu/retrieval/cli.py``.

A host tool in the aot/tune/cascade mold: no torch import on any of these
paths, so ``index build|add|ls|verify|compact|stats`` run on any machine
that can see the store directory. Vectors come in as ``.npy`` matrices with
ids from a text/JSON sidecar, or as seeded synthetic rows (``--random N
--seed S``: the same numpy draws as the JAX package's, so both build the
same rows bit for bit)::

    python -m jimm_tpu_torch index build  --store ./idx corpus --dim 512 --random 10000
    python -m jimm_tpu_torch index add    --store ./idx corpus --from-npy embs.npy --ids ids.txt
    python -m jimm_tpu_torch index ls     --store ./idx
    python -m jimm_tpu_torch index verify --store ./idx
    python -m jimm_tpu_torch index compact --store ./idx corpus
    python -m jimm_tpu_torch index stats  --store ./idx corpus

``train-centroids`` and ``build-ivf`` (JAX's IVF codebook) refuse: IVF is
ROADMAP.md queue 1 item 9 part 2.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

import numpy as np

from jimm_tpu_torch.retrieval.store import (RetrievalStoreError, VectorStore,
                                            normalize_rows)

__all__ = ["IVF_NOT_PORTED", "add_index_parser", "cmd_index", "main"]

#: what `index train-centroids|build-ivf` answer
IVF_NOT_PORTED = ("index {verb} is not ported yet: the IVF codebook, "
                  "ROADMAP.md queue 1 item 9 part 2")


def _load_ids(path: str, n: int) -> list[str]:
    """Ids sidecar: a JSON list, or one id per text line."""
    text = Path(path).read_text()
    try:
        ids = json.loads(text)
        if not isinstance(ids, list):
            raise ValueError("ids JSON must be a list")
    except ValueError:
        ids = [line.strip() for line in text.splitlines() if line.strip()]
    ids = [str(i) for i in ids]
    if len(ids) != n:
        raise SystemExit(f"{path} has {len(ids)} ids for {n} vectors")
    return ids


def random_rows(n: int, dim: int, seed: int) -> tuple[list[str], np.ndarray]:
    """``--random N --seed S``: JAX's ids and unit rows, bit for bit."""
    rng = np.random.default_rng(seed)
    mat = normalize_rows(rng.standard_normal((n, dim), dtype=np.float32))
    return [f"rand:{seed}:{i}" for i in range(n)], mat


def _rows_from_args(args: argparse.Namespace, dim: int | None
                    ) -> tuple[list[str], np.ndarray]:
    if args.from_npy:
        mat = np.load(args.from_npy)
        if mat.ndim != 2:
            raise SystemExit(f"{args.from_npy} must hold an (N, D) matrix; "
                             f"got shape {mat.shape}")
        ids = (_load_ids(args.ids, mat.shape[0]) if args.ids
               else [f"{Path(args.from_npy).stem}:{i}"
                     for i in range(mat.shape[0])])
        return ids, mat
    if args.random:
        if dim is None:
            raise SystemExit("--random needs --dim (or an existing index)")
        return random_rows(args.random, dim, args.seed)
    raise SystemExit("need --from-npy FILE (with optional --ids) or "
                     "--random N")


def _cmd_build(args: argparse.Namespace) -> int:
    store = VectorStore(args.store)
    dim = args.dim
    if dim is None and args.from_npy:
        dim = int(np.load(args.from_npy).shape[1])
    if dim is None:
        raise SystemExit("need --dim (or --from-npy to infer it)")
    store.create(args.name, dim, dtype=args.dtype, exist_ok=args.exist_ok)
    out = {"index": args.name, "dim": int(dim), "dtype": args.dtype}
    if args.from_npy or args.random:
        ids, mat = _rows_from_args(args, dim)
        out["segment"] = store.add(args.name, ids, mat)[:12]
        out["rows"] = len(ids)
    print(json.dumps(out))
    return 0


def _cmd_add(args: argparse.Namespace) -> int:
    store = VectorStore(args.store)
    man = store.manifest(args.name)
    ids, mat = _rows_from_args(args, int(man["dim"]))
    fp = store.add(args.name, ids, mat)
    print(json.dumps({"index": args.name, "segment": fp[:12],
                      "rows": len(ids),
                      "total_rows": store.stats(args.name)["rows"]}))
    return 0


def _cmd_ls(args: argparse.Namespace) -> int:
    store = VectorStore(args.store)
    rows = store.ls()
    if args.json:
        print(json.dumps(rows, indent=1))
        return 0
    if not rows:
        print(f"no indexes under {args.store}")
        return 0
    print(f"{'name':24s} {'rows':>8s} {'dim':>6s} {'dtype':10s} "
          f"{'segs':>5s} {'dead':>6s} {'bytes':>12s}")
    for r in rows:
        print(f"{r['name']:24s} {r['rows']:8d} {r['dim']:6d} "
              f"{r['dtype']:10s} {r['segments']:5d} {r['dead_rows']:6d} "
              f"{r['bytes']:12d}")
    return 0


def _cmd_verify(args: argparse.Namespace) -> int:
    store = VectorStore(args.store)
    problems = store.verify(args.name)
    for p in problems:
        print(json.dumps(p))
    summary = {"indexes": len([args.name] if args.name else store.names()),
               "problems": len(problems)}
    print(json.dumps(summary))
    return 1 if problems else 0


def _cmd_compact(args: argparse.Namespace) -> int:
    store = VectorStore(args.store)
    report = store.compact(args.name)
    print(json.dumps({"index": args.name, **report}))
    return 0


def _cmd_stats(args: argparse.Namespace) -> int:
    store = VectorStore(args.store)
    names = [args.name] if args.name else store.names()
    out = [store.stats(n) for n in names]
    doc = out if args.name is None else out[0]
    if args.json:
        print(json.dumps(doc, separators=(",", ":"), sort_keys=True))
    else:
        print(json.dumps(doc, indent=1))
    return 0


def _cmd_ivf(args: argparse.Namespace) -> int:
    raise SystemExit(IVF_NOT_PORTED.format(verb=args.index_cmd))


def cmd_index(args: argparse.Namespace) -> int:
    try:
        return args.index_func(args)
    except RetrievalStoreError as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def add_index_parser(subparsers) -> None:
    """Register ``index ...`` on a command line's subparsers."""
    p = subparsers.add_parser(
        "index", help="manage retrieval vector indexes (no torch needed)")
    p.set_defaults(func=cmd_index)
    sub = p.add_subparsers(dest="index_cmd", required=True)

    def _store_flag(sp):
        sp.add_argument("--store", required=True,
                        help="vector store root directory")

    sp = sub.add_parser("build", help="create an index (optionally "
                                      "seeding rows)")
    _store_flag(sp)
    sp.add_argument("name", help="index name")
    sp.add_argument("--dim", type=int, default=None,
                    help="embedding dimension (inferred from --from-npy)")
    sp.add_argument("--dtype", default="float32",
                    choices=["float32", "bfloat16"])
    sp.add_argument("--from-npy", default=None,
                    help="seed rows from an (N, D) .npy matrix")
    sp.add_argument("--ids", default=None,
                    help="ids sidecar for --from-npy (JSON list or one id "
                         "per line; default: derived from the file name)")
    sp.add_argument("--random", type=int, default=None, metavar="N",
                    help="seed N synthetic unit vectors (smoke/bench)")
    sp.add_argument("--seed", type=int, default=0)
    sp.add_argument("--exist-ok", action="store_true",
                    help="reuse an existing index instead of failing")
    sp.set_defaults(index_func=_cmd_build)

    sp = sub.add_parser("add", help="append rows to an index")
    _store_flag(sp)
    sp.add_argument("name")
    sp.add_argument("--from-npy", default=None)
    sp.add_argument("--ids", default=None)
    sp.add_argument("--random", type=int, default=None, metavar="N")
    sp.add_argument("--seed", type=int, default=1)
    sp.set_defaults(index_func=_cmd_add)

    sp = sub.add_parser("ls", help="list indexes with row/segment stats")
    _store_flag(sp)
    sp.add_argument("--json", action="store_true",
                    help="machine-readable output")
    sp.set_defaults(index_func=_cmd_ls)

    sp = sub.add_parser("verify",
                        help="re-validate manifests + segment payloads "
                             "(bad segments quarantine; exit 1 on problems)")
    _store_flag(sp)
    sp.add_argument("name", nargs="?", default=None,
                    help="one index (default: all)")
    sp.set_defaults(index_func=_cmd_verify)

    sp = sub.add_parser("compact",
                        help="fold live rows into one segment and drop "
                             "tombstoned bytes")
    _store_flag(sp)
    sp.add_argument("name")
    sp.set_defaults(index_func=_cmd_compact)

    # JAX's IVF verbs keep their flags and refuse
    for verb in ("train-centroids", "build-ivf"):
        sp = sub.add_parser(verb, help="IVF codebook: not ported yet "
                                       "(ROADMAP.md queue 1 item 9)")
        _store_flag(sp)
        sp.add_argument("name")
        if verb == "train-centroids":
            sp.add_argument("--clusters", type=int, required=True)
            sp.add_argument("--iters", type=int, default=25)
            sp.add_argument("--batch-rows", type=int, default=4096)
            sp.add_argument("--seed", type=int, default=0)
        sp.set_defaults(index_func=_cmd_ivf)

    sp = sub.add_parser("stats", help="row/segment stats (manifest-only)")
    _store_flag(sp)
    sp.add_argument("name", nargs="?", default=None,
                    help="one index (default: all)")
    sp.add_argument("--json", action="store_true",
                    help="one compact sorted-key JSON line")
    sp.set_defaults(index_func=_cmd_stats)


def main(argv: list[str] | None = None) -> int:
    """``python -m jimm_tpu_torch index ...`` (``argv[0]`` is ``index``)."""
    parser = argparse.ArgumentParser(prog="python -m jimm_tpu_torch")
    sub = parser.add_subparsers(dest="command", required=True)
    add_index_parser(sub)
    args = parser.parse_args(argv)
    return args.func(args)


if __name__ == "__main__":
    sys.exit(main(["index", *sys.argv[1:]]))
