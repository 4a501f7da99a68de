"""Graph JSON Schema generated from the model types.

The reference generates its schema from the Rust types with schemars
(commands/schema/generate_schema.rs:21-25) and codegens Python dataclasses
from it (Makefile:33-40). Here the model types ARE Python dataclasses
(graph/graph.py, graph/edits.py — shared by the analysis layer, so no
codegen step is needed), and this module derives the JSON Schema from their
field definitions, so schema and model cannot drift: a renamed or added
field changes the generated schema automatically. Domain constraints that
Python types cannot express (strand enum, single-char substitution, the
2-tuple position) are declared in `_REFINEMENTS`, keyed by (class, field).
"""
from __future__ import annotations

import dataclasses

import numpy as np

from pangraph_tpu_torch.graph.edits import Del, Edit, Ins, Sub
from pangraph_tpu_torch.graph.graph import Block, Node, Path

UINT = {"type": "integer", "minimum": 0}

# (class_name, field) -> schema fragment for constraints the type alone
# cannot express. Fields absent here fall back to type-derived schemas.
_REFINEMENTS = {
    ("Sub", "alt"): {"type": "string", "minLength": 1, "maxLength": 1},
    ("Node", "strand"): {"type": "string", "enum": ["+", "-"]},
    ("Node", "position"): {
        "type": "array",
        "items": UINT,
        "minItems": 2,
        "maxItems": 2,
    },
    # id-keyed maps serialized as JSON objects
    ("Path", "nodes"): {"type": "array", "items": UINT},
    ("Block", "consensus"): {"type": "string"},
    ("Block", "alignments"): None,  # filled in with the Edit schema below
    ("Edit", "subs"): None,
    ("Edit", "dels"): None,
    ("Edit", "inss"): None,
}

_OPTIONAL_FIELDS = {("Path", "name"), ("Path", "desc")}


def _field_schema(cls_name: str, f: dataclasses.Field, sub_schemas: dict) -> dict:
    key = (cls_name, f.name)
    if key in _REFINEMENTS and _REFINEMENTS[key] is not None:
        return _REFINEMENTS[key]
    if key in sub_schemas:
        return sub_schemas[key]
    t = f.type if isinstance(f.type, str) else getattr(f.type, "__name__", str(f.type))
    if t in ("int", "builtins.int"):
        return dict(UINT)
    if t in ("str", "builtins.str"):
        return {"type": ["string", "null"]} if key in _OPTIONAL_FIELDS else {"type": "string"}
    if t in ("bool", "builtins.bool"):
        return {"type": "boolean"}
    raise TypeError(f"no schema mapping for {cls_name}.{f.name}: {f.type}")


def _object_schema(cls, sub_schemas: dict = None, optional: set = frozenset()) -> dict:
    sub_schemas = sub_schemas or {}
    props, required = {}, []
    for f in dataclasses.fields(cls):
        props[f.name] = _field_schema(cls.__name__, f, sub_schemas)
        if (cls.__name__, f.name) not in _OPTIONAL_FIELDS:
            required.append(f.name)
    return {"type": "object", "required": required, "properties": props}


def _id_map(value_schema: dict) -> dict:
    return {"type": "object", "additionalProperties": value_schema}


def generate_schema() -> dict:
    """JSON Schema of the graph wire format, derived from the model types."""
    sub = _object_schema(Sub)
    dele = _object_schema(Del)
    ins = _object_schema(Ins)
    edit = _object_schema(
        Edit,
        sub_schemas={
            ("Edit", "subs"): {"type": "array", "items": sub},
            ("Edit", "dels"): {"type": "array", "items": dele},
            ("Edit", "inss"): {"type": "array", "items": ins},
        },
    )
    block = _object_schema(Block, sub_schemas={("Block", "alignments"): _id_map(edit)})
    node = _object_schema(Node)
    path = _object_schema(Path)
    return {
        "$schema": "http://json-schema.org/draft-07/schema#",
        "title": "Pangraph",
        "type": "object",
        "required": ["paths", "blocks", "nodes"],
        "properties": {
            "paths": _id_map(path),
            "blocks": _id_map(block),
            "nodes": _id_map(node),
        },
    }
