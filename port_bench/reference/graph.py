"""Rebuild every genome from a pangenome graph's JSON, as upstream
pangraph's `reconstruct` does (reconstruct_run.rs:78-120, edits.rs:307-331):
each path walks its nodes, each node's sequence is its block's consensus
with the node's edits applied (substitutions, then deletions, then
insertions before the given consensus position), reverse-complemented on
the '-' strand; the genome is the nodes' concatenation rotated right by
the first node's start."""
from __future__ import annotations

import json

import numpy as np

_COMP = np.arange(256, dtype=np.uint8)
for a, b in ("AT", "CG", "RY", "KM", "BV", "DH", "SS", "WW", "NN"):
    for x, y in ((a, b), (a.lower(), b.lower())):
        _COMP[ord(x)], _COMP[ord(y)] = ord(y), ord(x)


def revcomp(s: np.ndarray) -> np.ndarray:
    return _COMP[s[::-1]]


def apply_edits(cons: np.ndarray, edit: dict) -> np.ndarray:
    """A node's sequence from its block's consensus and its edit dict
    ({"subs": [{"pos", "alt"}], "dels": [{"pos", "len"}], "inss": [{"pos",
    "seq"}]})."""
    seq = cons.copy()
    subs = edit.get("subs") or []
    if subs:
        seq[np.array([s["pos"] for s in subs], dtype=np.int64)] = np.frombuffer(
            "".join(s["alt"] for s in subs).encode(), np.uint8)
    keep = np.ones(len(seq), dtype=bool)
    for d in edit.get("dels") or []:
        keep[d["pos"] : d["pos"] + d["len"]] = False
    inss = sorted(((i["pos"], i["seq"]) for i in edit.get("inss") or []))
    if not inss:
        return seq[keep]
    parts, prev = [], 0
    for pos, ins in inss:
        parts.append(seq[prev:pos][keep[prev:pos]])
        parts.append(np.frombuffer(ins.encode(), np.uint8))
        prev = pos
    parts.append(seq[prev:][keep[prev:]])
    return np.concatenate(parts)


def genomes(graph_json: str) -> dict:
    """{path name: genome bytes} for every path of the graph. A path whose
    nodes do not add up to its recorded length maps to None."""
    g = json.loads(graph_json)
    blocks, nodes = g["blocks"], g["nodes"]
    cons = {}
    out = {}
    for path in g["paths"].values():
        parts = []
        for nid in path["nodes"]:
            node = nodes[str(nid)]
            bid = str(node["block_id"])
            if bid not in cons:
                cons[bid] = np.frombuffer(blocks[bid]["consensus"].encode(), np.uint8)
            s = apply_edits(cons[bid], blocks[bid]["alignments"][str(nid)])
            parts.append(revcomp(s) if node["strand"] == "-" else s)
        seq = np.concatenate(parts) if parts else np.zeros(0, np.uint8)
        if len(seq) != path["tot_len"]:
            out[path["name"]] = None
            continue
        if path["nodes"]:
            seq = np.roll(seq, nodes[str(path["nodes"][0])]["position"][0])
        out[path["name"]] = seq
    return out


def mismatched(graph_json: str, inputs: dict) -> int:
    """How many input genomes ({name: bytes}) the graph does not give back
    byte for byte; a path the inputs lack counts too, and so does a graph
    that does not parse (as every input)."""
    try:
        got = genomes(graph_json)
    except (ValueError, KeyError, TypeError, IndexError):
        return len(inputs)
    bad = sum(1 for name, seq in inputs.items()
              if got.get(name) is None or not np.array_equal(got[name], seq))
    return bad + sum(1 for name in got if name not in inputs)
