"""The `build` pipeline: FASTAs -> singleton graphs -> guide tree -> postorder
merge -> pangenome graph.

Reference: commands/build/build_run.rs:66-185.
"""
from __future__ import annotations

import logging

import numpy as np

from pangraph_tpu_torch.align.mapper import MapperParams, map_all_vs_all
from pangraph_tpu_torch.align.params import BuildArgs
from pangraph_tpu_torch.build.merge import merge_graphs
from pangraph_tpu_torch.build.tree import balance_tree, build_guide_tree, guide_tree_from_newick
from pangraph_tpu_torch.graph.graph import Pangraph, reconstruct
from pangraph_tpu_torch.graph.seq import to_str
from pangraph_tpu_torch.utils import trace

log = logging.getLogger(__name__)

# how long a worker waits for a peer's claimed merge before computing it
# locally (matches the TCP checkpointer's internal default; ADVICE r4: the
# FS transport polled forever when a claimer died after claiming)
WAIT_FOR_TIMEOUT_S = float(__import__("os").environ.get("PANGRAPH_TPU_WAIT_FOR_TIMEOUT", 3600.0))


def make_find_matches(args: BuildArgs, aligner=None):
    """The find_matches callable for self_merge (graph_merging.rs:176-185).
    Maps all block consensuses against each other."""
    mp = MapperParams.from_sensitivity(
        args.aln_args.sensitivity, args.aln_args.indel_len_threshold, args.aln_args.kmer_length
    )

    def find_matches(blocks: dict, aln_args, pair_cache=None):
        seqs = {bid: b.consensus for bid, b in blocks.items()}
        return map_all_vs_all(
            seqs, mp, args.banded_params, aligner=aligner, n_threads=max(1, args.jobs),
            pair_cache=pair_cache,
        )

    find_matches.supports_pair_cache = True
    return find_matches


class MergeCheckpointer:
    """Checkpoint/resume at merge-tree granularity (SURVEY.md §5: the graph
    JSON is the natural checkpoint unit; the reference has none mid-build,
    bin/merge_two_graphs.rs only hints at it). Each completed internal clade's
    subgraph is written to `<dir>/merge-<fingerprint>.json.gz`, keyed by the
    sorted leaf-name set, so an interrupted build — or one re-run with more
    genomes sharing subtrees — resumes from the deepest completed merges."""

    def __init__(self, directory):
        import os

        self.dir = directory
        os.makedirs(directory, exist_ok=True)

    @staticmethod
    def fingerprint(leaf_names) -> str:
        import hashlib

        h = hashlib.blake2b("\n".join(sorted(leaf_names)).encode(), digest_size=12)
        return h.hexdigest()

    def _path(self, leaf_names):
        import os

        return os.path.join(self.dir, f"merge-{self.fingerprint(leaf_names)}.json.gz")

    def load(self, leaf_names):
        import os

        p = self._path(leaf_names)
        if os.path.exists(p):
            log.info("checkpoint hit: %s (%d leaves)", p, len(leaf_names))
            return Pangraph.from_file(p)
        return None

    def save(self, leaf_names, graph) -> None:
        import os

        p = self._path(leaf_names)
        # tmp name keeps the .json.gz suffix so compression sniffing applies
        tmp = os.path.join(self.dir, f".tmp-{os.getpid()}-{os.path.basename(p)}")
        graph.to_file(tmp)
        os.replace(tmp, p)

    # ------------------------------------------------- cross-process claims
    # The checkpoint directory doubles as the coordination medium for
    # multi-host builds: workers on a shared filesystem claim merges with
    # O_EXCL marker files and poll for the claimed merge's checkpoint. This
    # is the DCN-level merge-tree distribution of SURVEY.md §5 (subgraph
    # JSONs between merge levels); each worker drives its own device.

    def try_claim(self, leaf_names, stale_s: float = 3600.0) -> bool:
        import os
        import time

        p = os.path.join(self.dir, f"claim-{self.fingerprint(leaf_names)}")
        while True:
            try:
                fd = os.open(p, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
                os.write(fd, str(os.getpid()).encode())
                os.close(fd)
                return True
            except FileExistsError:
                try:
                    if time.time() - os.path.getmtime(p) > stale_s:
                        os.unlink(p)  # dead worker: take over
                        continue
                except OSError:
                    continue
                return False

    def wait_for(self, leaf_names, poll_s: float = 0.25, timeout_s: float = None):
        """Block until another worker's checkpoint for this clade appears."""
        import time

        t0 = time.time()
        while True:
            g = self.load(leaf_names)
            if g is not None:
                return g
            if timeout_s is not None and time.time() - t0 > timeout_s:
                raise TimeoutError(f"timed out waiting for merge checkpoint ({len(leaf_names)} leaves)")
            time.sleep(poll_s)


def build(records, args: BuildArgs, aligner=None, find_matches_override=None, progress=None) -> Pangraph:
    """records: list of FastaRecord. Returns the merged pangenome graph.

    `aligner` is used as given (ops.batch_align.BatchAligner, built by the
    caller for its device). None builds one for the card, which raises where
    there is no CUDA device: to run on the CPU, pass an aligner built for it
    (BatchAligner(..., device="cpu"), or device=None for the host engine).
    "numpy" aligns every job on its own with the numpy reference aligner,
    without batching, as the reference does where no C++ toolchain builds
    the host engine."""
    names = [r.seq_name for r in records]
    if len(set(names)) != len(names):
        raise ValueError("Duplicate sequence names in input")

    if aligner is None:
        from pangraph_tpu_torch.ops.batch_align import BatchAligner

        aligner = BatchAligner(args.banded_params, args.extra_band_width, args.max_alignment_attempts, device="cuda")
    elif aligner == "numpy":
        aligner = None  # the merges' and the mapper's own numpy paths

    graphs = {r.index: Pangraph.singleton(r.seq_name, r.seq, r.index, args.circular, desc=r.desc) for r in records}

    trace.new_build()
    with trace.span("build.guide_tree"):
        if args.guide_tree:
            with open(args.guide_tree) as f:
                tree = guide_tree_from_newick(f.read(), names)
        else:
            tree = build_guide_tree(names, [r.seq for r in records])
            tree = balance_tree(tree)
    log.info("guide tree: %s", tree.to_newick())

    find_matches = find_matches_override or make_find_matches(args, aligner)

    if tree.is_leaf():
        return graphs[tree.data]

    ckpt = MergeCheckpointer(args.checkpoint_dir) if getattr(args, "checkpoint_dir", None) else None
    coordinate_arg = getattr(args, "coordinate", False)
    if isinstance(coordinate_arg, str):
        if not coordinate_arg.startswith("tcp://"):
            # a typo'd scheme falling through to the file transport (or to a
            # solo build when no checkpoint dir is set) would repeat all the
            # work without a warning
            raise ValueError(
                f"unsupported --coordinate transport {coordinate_arg!r} (expected tcp://HOST:PORT)"
            )
        # the TCP claim and exchange transport: the same interface, no shared
        # filesystem (a --checkpoint-dir is still written through, for resume)
        from pangraph_tpu_torch.parallel.coordinator import TcpMergeCheckpointer

        ckpt = TcpMergeCheckpointer(coordinate_arg, local=ckpt)
    # leaf clade data is the record index; map to names for checkpoint keys
    leaf_names = {}
    if ckpt is not None:
        by_index = {r.index: r.seq_name for r in records}
        for c in tree.postorder():
            if c.is_leaf():
                leaf_names[id(c)] = [by_index[c.data]]
            else:
                leaf_names[id(c)] = leaf_names[id(c.left)] + leaf_names[id(c.right)]

    # resume: restore the deepest completed subtrees top-down, so nothing
    # below a checkpointed clade is recomputed (or even scheduled)
    restored = set()
    if ckpt is not None:

        def restore(c):
            if c.is_leaf():
                return
            g = ckpt.load(leaf_names[id(c)])
            if g is not None:
                c.data = g
                restored.add(id(c))
                return
            restore(c.left)
            restore(c.right)

        restore(tree)
        if id(tree) in restored:
            graph = tree.data
            if args.verify:
                verify_roundtrip(graph, records)
            return graph

    covered = _ids_below_restored(tree, restored)

    jobs = args.jobs or 1
    if jobs > 1:
        graph = _merge_tree_parallel(
            tree, graphs, args, find_matches, aligner, jobs, ckpt, leaf_names, restored, covered, progress
        )
    else:
        n_merges = sum(
            1 for c in tree.postorder() if not c.is_leaf() and id(c) not in restored and id(c) not in covered
        )
        done = 0
        for clade in tree.postorder():
            if id(clade) in restored or id(clade) in covered:
                continue
            if clade.is_leaf():
                clade.data = graphs[clade.data]
                continue
            coordinate = ckpt is not None and getattr(args, "coordinate", False)
            claimed = not coordinate or ckpt.try_claim(leaf_names[id(clade)])
            if not claimed:
                try:
                    # finite timeout on EVERY transport: FS-mode wait_for
                    # with timeout_s=None polls forever, so a claimer that
                    # died after claiming would hang waiters indefinitely
                    # (ADVICE r4); degrade to local compute instead
                    clade.data = ckpt.wait_for(leaf_names[id(clade)], timeout_s=WAIT_FOR_TIMEOUT_S)
                except TimeoutError:
                    claimed = True  # coordinator/peer gone: compute locally
            if claimed:
                left, right = clade.left.data, clade.right.data
                log.info("merging graphs (%d + %d paths)", len(left.paths), len(right.paths))
                clade.data = merge_graphs(left, right, args, find_matches, aligner)
                if ckpt:
                    ckpt.save(leaf_names[id(clade)], clade.data)
            clade.left.data = clade.right.data = None  # free child graphs
            done += 1
            log.info("merge %d/%d complete -> %d blocks", done, n_merges, len(clade.data.blocks))
            if progress is not None:
                progress.tick(f"{len(clade.data.blocks)} blocks")
        graph = tree.data
    if args.verify:
        verify_roundtrip(graph, records)
    return graph


def _ids_below_restored(tree, restored: set) -> set:
    """ids of clades strictly below a checkpoint-restored ancestor (their
    work is already covered; they are neither merged nor scheduled)."""
    out = set()

    def walk(c, below):
        if below:
            out.add(id(c))
        if not c.is_leaf():
            nb = below or (id(c) in restored)
            walk(c.left, nb)
            walk(c.right, nb)

    walk(tree, False)
    return out


def _merge_tree_parallel(
    tree, graphs, args, find_matches, aligner, jobs: int, ckpt=None, leaf_names=None, restored=None,
    covered=None, progress=None,
):
    """Dependency-driven merge schedule: independent guide-tree nodes run on a
    host thread pool, so one merge's host bookkeeping (reweave, reconsensus
    interval arithmetic) overlaps another's device alignment batches. The
    balanced guide tree (tree.balance_tree) gives ~n/2 independent merges at
    the bottom level. This re-enables the parallelism the reference disabled
    (tree/balance.rs:6, neighbor_joining.rs:30-31)."""
    import concurrent.futures as cf

    restored = restored or set()
    covered = covered or set()
    for c in tree.postorder():
        if c.is_leaf() and id(c) not in covered:
            c.data = graphs[c.data]
    internals = [
        c for c in tree.postorder() if not c.is_leaf() and id(c) not in restored and id(c) not in covered
    ]
    parent = {}
    pending = {}
    for c in internals:
        pending[id(c)] = sum(
            1 for ch in (c.left, c.right) if not ch.is_leaf() and id(ch) not in restored
        )
        for ch in (c.left, c.right):
            parent[id(ch)] = c
    n_merges = len(internals)
    done = 0

    coordinate = ckpt is not None and getattr(args, "coordinate", False)

    def run(c):
        g = None
        if coordinate and not ckpt.try_claim(leaf_names[id(c)]):
            try:
                # finite timeout (see the serial path): a dead claimer must
                # degrade to local compute on the FS transport too
                g = ckpt.wait_for(leaf_names[id(c)], timeout_s=WAIT_FOR_TIMEOUT_S)
            except TimeoutError:
                g = None  # coordinator/peer gone: compute locally below
        if g is None:
            g = merge_graphs(c.left.data, c.right.data, args, find_matches, aligner)
            if ckpt is not None:
                ckpt.save(leaf_names[id(c)], g)
        c.left.data = c.right.data = None
        c.data = g
        return c

    run = trace.carry(run)  # the pool's spans take this build's id
    with cf.ThreadPoolExecutor(max_workers=jobs) as ex:
        futures = {ex.submit(run, c): c for c in internals if pending[id(c)] == 0}
        while futures:
            finished, _ = cf.wait(list(futures), return_when=cf.FIRST_COMPLETED)
            for f in finished:
                futures.pop(f)
                c = f.result()
                done += 1
                log.info("merge %d/%d complete -> %d blocks", done, n_merges, len(c.data.blocks))
                if progress is not None:
                    progress.tick(f"{len(c.data.blocks)} blocks")
                p = parent.get(id(c))
                if p is not None:
                    pending[id(p)] -= 1
                    if pending[id(p)] == 0:
                        futures[ex.submit(run, p)] = p
    return tree.data


def verify_roundtrip(graph: Pangraph, records) -> None:
    """The lossless-roundtrip oracle (build_run.rs:37-64): reconstructed
    sequences must equal the input byte-for-byte."""
    by_name = {r.seq_name: r.seq for r in records}
    count = 0
    for name, desc, seq in reconstruct(graph):
        expected = by_name[name]
        if len(seq) != len(expected) or not np.array_equal(seq, expected):
            raise AssertionError(f"Roundtrip mismatch for {name}: got {len(seq)} bp, expected {len(expected)} bp")
        count += 1
    if count != len(records):
        raise AssertionError(f"Reconstructed {count} sequences, expected {len(records)}")


def build_from_fasta(paths, args: BuildArgs) -> Pangraph:
    from pangraph_tpu_torch.io.fasta import read_fasta

    return build(read_fasta(paths), args)
