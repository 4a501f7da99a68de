"""Command-line interface.

Mirrors pangraph_tpu.cli (itself the reference's commands/root_args.rs
surface): build, export {gfa, block-consensus, block-sequences,
core-genome}, simplify, reconstruct, schema, completions, help-markdown and
merge. `build` and `merge` choose where the alignment kernels run with
`--device {cuda,cpu}`, or run every alignment on the host C++ engine with
`--no-tpu`; `build --devices N` splits its alignment launches over N cards
(parallel/mesh.py). Run as `python -m pangraph_tpu_torch.cli` or through the
`pangraph-tpu-torch` entry point.
"""
from __future__ import annotations

import argparse
import logging
import sys

PROG = "pangraph-tpu-torch"


def _add_verbosity(p, jobs_help: str = "Number of host threads (advisory)"):
    p.add_argument("-v", "--verbose", action="count", default=0, help="Increase verbosity")
    p.add_argument("-q", "--quiet", action="count", default=0, help="Decrease verbosity")
    p.add_argument("--verbosity", default=None, help="Set verbosity level explicitly")
    p.add_argument("--silent", action="store_true", help="Disable all console output")
    p.add_argument("-j", "--jobs", type=int, default=None, help=jobs_help)


def _add_device(p):
    p.add_argument(
        "--device",
        choices=["cuda", "cpu"],
        default="cuda",
        help="Where the alignment kernels run: 'cuda' (the CUDA kernels) or 'cpu' (their plain PyTorch versions)",
    )
    p.add_argument("--no-tpu", action="store_true", help="Run every alignment on the host C++ engine")


def build_parser():
    p = argparse.ArgumentParser(prog=PROG, description="Pangenome graph toolkit (PyTorch/CUDA)")
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
    b.add_argument(
        "-k", "--alignment-kernel", default="minimap2", choices=["minimap2", "mmseqs"], help="Alignment backend"
    )
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
    _add_device(b)
    b.add_argument(
        "--devices",
        type=int,
        default=None,
        help="Split alignment launches over this many CUDA cards (default: every visible card; 1 disables "
        "the mesh); under --device cpu, over this many CPU shards (default 1)",
    )
    b.add_argument("--trace", action="store_true",
                   help="Print a per-phase table at the end (calls, inclusive and self seconds, parent) and, on a "
                        "CUDA device, the card's busy share, kernel seconds by name and idle seconds by innermost span")
    b.add_argument("--no-progress-bar", action="store_true")
    b.add_argument("--upper-case", action="store_true", help="Uppercase input sequences (always on)")
    _add_verbosity(b, jobs_help="Number of merge threads")

    e = sub.add_parser("export", help="Export a pangenome graph")
    esub = e.add_subparsers(dest="export_what", required=True)

    eg = esub.add_parser("gfa", help="Export GFA v1")
    eg.add_argument("input_json")
    eg.add_argument("-o", "--output", default="-")
    eg.add_argument("--minimum-length", type=int, default=None)
    eg.add_argument("--maximum-length", type=int, default=None)
    eg.add_argument("--minimum-depth", type=int, default=None)
    eg.add_argument("--maximum-depth", type=int, default=None)
    eg.add_argument("--include-sequences", action="store_true")
    eg.add_argument("--no-duplicated", action="store_true")
    _add_verbosity(eg)

    ec = esub.add_parser("block-consensus", help="Export block consensus sequences to FASTA")
    ec.add_argument("input_json")
    ec.add_argument("-o", "--output", default="-")
    _add_verbosity(ec)

    es = esub.add_parser("block-sequences", help="Export per-block sequences (one FASTA per block)")
    es.add_argument("input_json")
    es.add_argument("-o", "--output", required=True, help="Output directory")
    es.add_argument("--unaligned", action="store_true")
    _add_verbosity(es)

    ek = esub.add_parser("core-genome", help="Export core-genome alignment")
    ek.add_argument("input_json")
    ek.add_argument("-o", "--output", default="-")
    ek.add_argument("--guide-strain", required=True)
    ek.add_argument("--unaligned", action="store_true")
    _add_verbosity(ek)

    s = sub.add_parser("simplify", help="Keep only selected strains and re-compact")
    s.add_argument("input_json")
    s.add_argument("-o", "--output-json", default="-")
    s.add_argument("-s", "--strains", required=True, help="Comma-separated strain names to keep")
    _add_verbosity(s)

    r = sub.add_parser("reconstruct", help="Reconstruct input sequences from the graph")
    r.add_argument("input_json")
    r.add_argument("-o", "--output-fasta", default="-")
    r.add_argument("--verify", default=None, help="FASTA to compare reconstruction against")
    _add_verbosity(r)

    sc = sub.add_parser("schema", help="Emit the graph JSON schema")
    sc.add_argument("-o", "--output", default="-")
    _add_verbosity(sc)

    co = sub.add_parser("completions", help="Generate shell completions")
    co.add_argument("shell", choices=["bash", "zsh", "fish"], nargs="?", default="bash")

    sub.add_parser("help-markdown", help="Print the CLI reference as Markdown")

    mg = sub.add_parser("merge", help="Merge two pangenome graph JSONs directly (dev tool; bin/merge_two_graphs.rs)")
    mg.add_argument("left_json")
    mg.add_argument("right_json")
    mg.add_argument("-o", "--output-json", default="-")
    mg.add_argument("-c", "--circular", action="store_true")
    _add_device(mg)
    _add_verbosity(mg)

    return p


def _setup_logging(args):
    level = logging.WARNING
    v = getattr(args, "verbose", 0) - getattr(args, "quiet", 0)
    if getattr(args, "silent", False):
        level = logging.CRITICAL
    elif getattr(args, "verbosity", None):
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

    debug = bool(os.environ.get("PANGRAPH_TPU_DEBUG")) or getattr(args, "verbose", 0) > 0
    try:
        return _dispatch(args)
    except (ValueError, OSError, KeyError, RuntimeError) as e:
        if debug:
            raise
        print(f"error: {e}", file=sys.stderr)
        return 1


def _dispatch(args) -> int:
    if args.command == "build":
        return _cmd_build(args)
    if args.command == "export":
        return _cmd_export(args)
    if args.command == "simplify":
        return _cmd_simplify(args)
    if args.command == "reconstruct":
        return _cmd_reconstruct(args)
    if args.command == "schema":
        from pangraph_tpu_torch.commands import export_schema

        out = export_schema(None if args.output == "-" else args.output)
        if args.output == "-":
            sys.stdout.write(out)
        return 0
    if args.command == "completions":
        sys.stdout.write(_completions(args.shell))
        return 0
    if args.command == "help-markdown":
        sys.stdout.write(_help_markdown())
        return 0
    if args.command == "merge":
        return _cmd_merge(args)
    return 2


def _no_card(args) -> bool:
    """True, with the error printed, where `--device cuda` finds no CUDA
    device: the command then exits 1 and runs nothing on the CPU."""
    if args.no_tpu or args.device != "cuda":
        return False
    import torch

    if torch.cuda.is_available():
        return False
    print("error: --device cuda: no CUDA device is available (--device cpu runs the kernels' "
          "plain versions, --no-tpu the host engine)", file=sys.stderr)
    return True


def _mesh(args):
    """The mesh that `build --devices` asks for, or None for one device and
    under --no-tpu. More devices than there are raises ValueError (exit 1);
    this runs before any aligner is built."""
    if args.no_tpu:
        return None
    import os

    import torch

    if args.device == "cuda":
        have, what = torch.cuda.device_count(), "CUDA device(s)"
        n = have if args.devices is None else args.devices
    else:
        have, what = os.cpu_count() or 1, "CPU core(s)"
        n = 1 if args.devices is None else args.devices
    if n > have:
        raise ValueError(f"--devices {n}: only {have} {what} available")
    if n <= 1:
        return None
    from pangraph_tpu_torch.parallel.mesh import make_mesh

    return make_mesh(n, device=args.device)


def _aligner(args, build_args, mesh=None):
    """The BatchAligner for `--device` (or the host engine under --no-tpu),
    its launches split over `mesh` where one is given; None under --no-tpu
    where no C++ toolchain builds the host engine: the numpy aligner then
    aligns every job on its own, as the reference does."""
    from pangraph_tpu_torch import native
    from pangraph_tpu_torch.ops.batch_align import BatchAligner

    if args.no_tpu and native.get_lib() is None:
        return None
    return BatchAligner(
        build_args.banded_params, build_args.extra_band_width, build_args.max_alignment_attempts,
        device=None if args.no_tpu else args.device, mesh=mesh,
    )


def build_args_of(args):
    """The BuildArgs of a parsed `build` command line."""
    from pangraph_tpu_torch.align.params import AlignmentArgs, BuildArgs

    return BuildArgs(
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


def _cmd_build(args) -> int:
    from pangraph_tpu_torch.build.build import build
    from pangraph_tpu_torch.io.fasta import read_fasta
    from pangraph_tpu_torch.utils import trace
    from pangraph_tpu_torch.utils.progress import ProgressBar

    if _no_card(args):
        return 1
    mesh = _mesh(args)
    build_args = build_args_of(args)
    find_matches = None
    if args.alignment_kernel == "mmseqs":
        # mmseqs finds the matches; the merges' alignments still go through
        # the aligner, on the device chosen
        from pangraph_tpu_torch.align.mmseqs import check_mmseqs, make_mmseqs_find_matches

        check_mmseqs()
        find_matches = make_mmseqs_find_matches(build_args)
    aligner = _aligner(args, build_args, mesh)
    card = args.trace and aligner is not None and aligner.device is not None and aligner.device.type == "cuda"
    if args.trace:
        trace.enable(True)
    if card:
        from pangraph_tpu_torch.ops import stripe_v2

        stripe_v2.KERNEL_TIMING = []
        for dev in dict.fromkeys(aligner.mesh.devices):
            trace.anchor_device(dev)
    recs = read_fasta(args.input_fastas)
    progress = ProgressBar(max(len(recs) - 1, 1), enabled=not args.no_progress_bar)
    graph = build(recs, build_args, aligner="numpy" if aligner is None else aligner,
                  find_matches_override=find_matches, progress=progress)
    progress.close()
    graph.to_file(None if args.output_json == "-" else args.output_json)
    if args.trace:
        launches = None
        if card:
            launches = [(name, index, start, end) for name, _B, _R, _m, index, start, end, _s in stripe_v2.KERNEL_TIMING]
            stripe_v2.KERNEL_TIMING = None
        print(trace.summary(launches), file=sys.stderr)
    return 0


def _cmd_export(args) -> int:
    from pangraph_tpu_torch.graph.graph import Pangraph

    graph = Pangraph.from_file(args.input_json)
    if args.export_what == "gfa":
        from pangraph_tpu_torch.io.gfa import GfaParams, gfa_write

        gfa_write(
            graph,
            None if args.output == "-" else args.output,
            GfaParams(
                minimum_length=args.minimum_length,
                maximum_length=args.maximum_length,
                minimum_depth=args.minimum_depth,
                maximum_depth=args.maximum_depth,
                include_sequences=args.include_sequences,
                no_duplicated=args.no_duplicated,
            ),
        )
    elif args.export_what == "block-consensus":
        from pangraph_tpu_torch.commands import export_block_consensus

        export_block_consensus(graph, None if args.output == "-" else args.output)
    elif args.export_what == "block-sequences":
        from pangraph_tpu_torch.commands import export_block_sequences

        export_block_sequences(graph, args.output, unaligned=args.unaligned)
    elif args.export_what == "core-genome":
        from pangraph_tpu_torch.commands import export_core_genome

        export_core_genome(
            graph, args.guide_strain, None if args.output == "-" else args.output, unaligned=args.unaligned
        )
    return 0


def _cmd_simplify(args) -> int:
    from pangraph_tpu_torch.commands import simplify
    from pangraph_tpu_torch.graph.graph import Pangraph

    graph = Pangraph.from_file(args.input_json)
    graph = simplify(graph, args.strains.split(","))
    graph.to_file(None if args.output_json == "-" else args.output_json)
    return 0


def _cmd_reconstruct(args) -> int:
    from pangraph_tpu_torch.commands import reconstruct_to_fasta
    from pangraph_tpu_torch.graph.graph import Pangraph, reconstruct
    from pangraph_tpu_torch.graph.seq import to_str
    from pangraph_tpu_torch.io.fasta import read_fasta

    graph = Pangraph.from_file(args.input_json)
    if args.verify:
        expected = {r.seq_name: r.seq for r in read_fasta(args.verify)}
        ok = True
        for name, desc, seq in reconstruct(graph):
            exp = expected.get(name)
            if exp is None:
                print(f"MISSING {name}: not in verification FASTA", file=sys.stderr)
                ok = False
            elif to_str(seq) != to_str(exp):
                print(f"MISMATCH {name}: {len(seq)} bp vs expected {len(exp)} bp", file=sys.stderr)
                ok = False
        if ok:
            print("All sequences reconstructed exactly", file=sys.stderr)
        return 0 if ok else 1
    reconstruct_to_fasta(graph, None if args.output_fasta == "-" else args.output_fasta)
    return 0


def _cmd_merge(args) -> int:
    """Merge two serialized graphs (reference dev tool bin/merge_two_graphs.rs),
    aligning on the device `--device` names, as `build` does."""
    from pangraph_tpu_torch.align.params import BuildArgs
    from pangraph_tpu_torch.build.build import make_find_matches
    from pangraph_tpu_torch.build.merge import merge_graphs
    from pangraph_tpu_torch.graph.graph import Pangraph

    if _no_card(args):
        return 1
    left = Pangraph.from_file(args.left_json)
    right = Pangraph.from_file(args.right_json)
    build_args = BuildArgs(circular=args.circular)
    aligner = _aligner(args, build_args)
    graph = merge_graphs(left, right, build_args, make_find_matches(build_args, aligner), aligner)
    graph.to_file(None if args.output_json == "-" else args.output_json)
    return 0
def _help_markdown() -> str:
    """Render the whole CLI as a Markdown reference (reference:
    commands/md_help -> docs/docs/reference.md)."""
    parser = build_parser()
    out = [f"# {PROG} CLI reference", "", "```", parser.format_help().rstrip(), "```", ""]
    subs = next(a for a in parser._actions if isinstance(a, argparse._SubParsersAction))
    seen = set()
    for name, sp in subs.choices.items():
        if id(sp) in seen:
            continue
        seen.add(id(sp))
        out += [f"## `{PROG} {name}`", "", "```", sp.format_help().rstrip(), "```", ""]
        for a in sp._actions:
            if isinstance(a, argparse._SubParsersAction):
                for n2, sp2 in a.choices.items():
                    out += [f"### `{PROG} {name} {n2}`", "", "```", sp2.format_help().rstrip(), "```", ""]
    return "\n".join(out)


def _parser_tree():
    """{(subcommand path): {flag: help}} introspected from the live parser —
    completions can never drift from the CLI (the reference generates its
    completions from the clap definition the same way, root_args.rs:125)."""
    tree = {}

    def walk(parser, path):
        flags = {}
        subs = {}
        for a in parser._actions:
            if isinstance(a, argparse._SubParsersAction):
                for name, sp in a.choices.items():
                    subs[name] = sp
            else:
                for s in a.option_strings:
                    flags[s] = (a.help or "").replace("'", "").replace('"', "")
        tree[path] = (flags, sorted(subs))
        for name, sp in subs.items():
            walk(sp, path + (name,))

    walk(build_parser(), ())
    return tree


def _completions(shell: str) -> str:
    tree = _parser_tree()
    fn = "_" + PROG.replace("-", "_")  # the shell function's name

    if shell == "bash":
        cases = []
        for path, (flags, subs) in tree.items():
            words = " ".join(sorted(flags) + subs)
            key = " ".join(path) if path else "_root"
            cases.append(f'    "{key}") words="{words}" ;;')
        return (
            f"{fn}() {{\n"
            '  local cur="${COMP_WORDS[COMP_CWORD]}" words path=""\n'
            "  local -a ctx=()\n"
            '  for ((i=1; i<COMP_CWORD; i++)); do\n'
            '    [[ "${COMP_WORDS[i]}" == -* ]] || ctx+=("${COMP_WORDS[i]}")\n'
            "  done\n"
            '  path="${ctx[*]:-_root}"\n'
            '  case "$path" in\n' + "\n".join(cases) + "\n"
            '    *) words="" ;;\n'
            "  esac\n"
            '  if [[ -n "$words" && ( "$cur" == -* || -n "${ctx[*]}" == "" ) ]]; then\n'
            '    COMPREPLY=( $(compgen -W "$words" -- "$cur") )\n'
            "  fi\n"
            '  [[ ${#COMPREPLY[@]} -eq 0 ]] && COMPREPLY=( $(compgen -f -- "$cur") )\n'
            "}\n"
            f"complete -o filenames -F {fn} {PROG}\n"
        )

    if shell == "zsh":
        out = [f"#compdef {PROG}", "", f"{fn}() {{"]
        root_flags, root_subs = tree[()]
        out.append("  local -a subcmds=(" + " ".join(root_subs) + ")")
        out.append('  if (( CURRENT == 2 )); then')
        out.append("    _describe 'command' subcmds")
        flag_specs = " ".join(f"'{f}[{h}]'" for f, h in sorted(root_flags.items()))
        out.append(f"    _arguments {flag_specs}")
        out.append("    return")
        out.append("  fi")
        out.append('  case "$words[2]" in')
        for path, (flags, subs) in tree.items():
            if len(path) != 1:
                continue
            specs = " ".join(f"'{f}[{h}]'" for f, h in sorted(flags.items()))
            sub2 = ""
            if subs:
                sub2 = f" '1: :({' '.join(subs)})'"
            out.append(f"    {path[0]}) _arguments {specs}{sub2} '*:file:_files' ;;")
        out.append("  esac")
        out.append("}")
        out.append(fn)
        return "\n".join(out) + "\n"

    # fish
    lines = []
    _, root_subs = tree[()]
    for name in root_subs:
        lines.append(
            f"complete -c {PROG} -n '__fish_use_subcommand' -a {name}"
        )
    for path, (flags, subs) in tree.items():
        if not path:
            continue
        cond = f"__fish_seen_subcommand_from {path[0]}"
        for f, h in sorted(flags.items()):
            if f.startswith("--"):
                lines.append(f"complete -c {PROG} -n '{cond}' -l {f[2:]} -d '{h}'")
            elif f.startswith("-") and len(f) == 2:
                lines.append(f"complete -c {PROG} -n '{cond}' -s {f[1]} -d '{h}'")
        for s in subs:
            lines.append(f"complete -c {PROG} -n '{cond}' -a {s}")
    return "\n".join(lines) + "\n"



def entry() -> int:
    """Console-script entry point."""
    return main()


if __name__ == "__main__":
    sys.exit(main())
