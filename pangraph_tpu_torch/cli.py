"""Command-line interface: the `build` subcommand.

Mirrors pangraph_tpu.cli's `build` (itself the reference's
commands/root_args.rs build surface), with the alignment device chosen by
`--device {cuda,cpu}`. Run as `python -m pangraph_tpu_torch.cli build ...`.
"""
from __future__ import annotations

import argparse
import logging
import sys


def build_parser():
    p = argparse.ArgumentParser(prog="pangraph-tpu-torch", description="Pangenome graph toolkit (PyTorch/CUDA)")
    sub = p.add_subparsers(dest="command", required=True)

    b = sub.add_parser("build", help="Align genomes into a multiple sequence alignment graph")
    b.add_argument("input_fastas", nargs="+", help="Input FASTA files (optionally compressed)")
    b.add_argument("-o", "--output-json", default="-", help="Output graph JSON path ('-' = stdout)")
    b.add_argument("-l", "--len", dest="indel_len_threshold", type=int, default=100, help="Minimum block size")
    b.add_argument("-a", "--alpha", type=float, default=100.0, help="Energy cost of block splits")
    b.add_argument("-b", "--beta", type=float, default=10.0, help="Energy cost of alignment diversity")
    b.add_argument("-c", "--circular", action="store_true", help="Treat genomes as circular")
    b.add_argument("-x", "--max-self-map", type=int, default=100, help="Max self-merge iterations")
    b.add_argument("-s", "--sensitivity", type=int, default=10, help="Alignment preset: 5/10/20 (asm5/10/20)")
    b.add_argument("-K", "--kmer-length", type=int, default=None, help="k-mer length override")
    b.add_argument("-f", "--verify", action="store_true", help="Verify lossless reconstruction")
    b.add_argument("--extra-band-width", type=int, default=5)
    b.add_argument("--max-alignment-attempts", type=int, default=4)
    b.add_argument("--guide-tree", default=None, help="Newick guide tree path")
    b.add_argument(
        "--checkpoint-dir",
        default=None,
        help="Directory for merge-tree checkpoints; an interrupted build resumes from completed subgraphs",
    )
    b.add_argument(
        "--coordinate",
        nargs="?",
        const=True,
        default=False,
        metavar="tcp://HOST:PORT",
        help="Share one build across workers: the bare flag claims merges through marker files in "
        "--checkpoint-dir (a shared filesystem); with tcp://HOST:PORT, claims and subgraphs go through "
        "a coordination server (the first worker to bind it hosts it), with no shared filesystem",
    )
    b.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="Where the alignment kernels run: 'cuda' (the CUDA kernels) or 'cpu' (their plain PyTorch versions)",
    )
    b.add_argument("--no-tpu", action="store_true", help="Run every alignment on the host C++ engine")
    b.add_argument("--trace", action="store_true", help="Log per-phase wall-time breakdown at the end")
    b.add_argument("--no-progress-bar", action="store_true")
    b.add_argument("--upper-case", action="store_true", help="Uppercase input sequences (always on)")
    b.add_argument("-v", "--verbose", action="count", default=0, help="Increase verbosity")
    b.add_argument("-q", "--quiet", action="count", default=0, help="Decrease verbosity")
    b.add_argument("--verbosity", default=None, help="Set verbosity level explicitly")
    b.add_argument("--silent", action="store_true", help="Disable all console output")
    b.add_argument("-j", "--jobs", type=int, default=None, help="Number of merge threads")
    return p


def _setup_logging(args):
    level = logging.WARNING
    v = args.verbose - args.quiet
    if args.silent:
        level = logging.CRITICAL
    elif args.verbosity:
        level = getattr(logging, str(args.verbosity).upper(), logging.WARNING)
    elif v >= 2:
        level = logging.DEBUG
    elif v == 1:
        level = logging.INFO
    logging.basicConfig(level=level, format="%(asctime)s %(levelname)-5s %(name)s: %(message)s")


def main(argv=None) -> int:
    """Dispatch with clean one-line errors; tracebacks are shown with -v or
    PANGRAPH_TPU_DEBUG=1."""
    args = build_parser().parse_args(argv)
    _setup_logging(args)
    import os

    debug = bool(os.environ.get("PANGRAPH_TPU_DEBUG")) or args.verbose > 0
    try:
        return _cmd_build(args)
    except (ValueError, OSError, KeyError, RuntimeError) as e:
        if debug:
            raise
        print(f"error: {e}", file=sys.stderr)
        return 1


def _cmd_build(args) -> int:
    from pangraph_tpu_torch import native
    from pangraph_tpu_torch.align.params import AlignmentArgs, BuildArgs
    from pangraph_tpu_torch.build.build import build
    from pangraph_tpu_torch.io.fasta import read_fasta
    from pangraph_tpu_torch.ops.batch_align import BatchAligner
    from pangraph_tpu_torch.utils import trace
    from pangraph_tpu_torch.utils.progress import ProgressBar

    if not args.no_tpu and args.device == "cuda":
        import torch

        if not torch.cuda.is_available():
            print("error: --device cuda: no CUDA device is available (--device cpu runs the kernels' "
                  "plain versions, --no-tpu the host engine)", file=sys.stderr)
            return 1
    build_args = BuildArgs(
        circular=args.circular,
        max_self_map=args.max_self_map,
        extra_band_width=args.extra_band_width,
        max_alignment_attempts=args.max_alignment_attempts,
        verify=args.verify,
        guide_tree=args.guide_tree,
        jobs=args.jobs or 1,
        checkpoint_dir=args.checkpoint_dir,
        coordinate=args.coordinate,
        aln_args=AlignmentArgs(
            indel_len_threshold=args.indel_len_threshold,
            alpha=args.alpha,
            beta=args.beta,
            sensitivity=args.sensitivity,
            kmer_length=args.kmer_length,
        ),
    )
    if args.no_tpu and native.get_lib() is None:
        aligner = "numpy"  # no C++ toolchain: the numpy aligner, as the reference does
    else:
        aligner = BatchAligner(
            build_args.banded_params, build_args.extra_band_width, build_args.max_alignment_attempts,
            device=None if args.no_tpu else args.device,
        )
    if args.trace:
        trace.enable(True)
    recs = read_fasta(args.input_fastas)
    progress = ProgressBar(max(len(recs) - 1, 1), enabled=not args.no_progress_bar)
    graph = build(recs, build_args, aligner=aligner, progress=progress)
    progress.close()
    if args.trace:
        print(trace.summary(), file=sys.stderr)
    graph.to_file(None if args.output_json == "-" else args.output_json)
    return 0


if __name__ == "__main__":
    sys.exit(main())
