"""ProgramDesc protobuf wire format (port of paddle_tpu/static/
proto_io.py, which imports no JAX; the port keeps its own copy).

Reference: paddle/fluid/framework/framework.proto:202 (ProgramDesc ->
BlockDesc -> VarDesc/OpDesc). Programs are written in the SAME proto2
wire format as the reference's `__model__` files, for the structural
subset a Program records (vars with type/shape/persistable, ops with
type and input/output argument lists); the bytes of a program are
those the JAX package writes for the same program. The codec is a small
pure-Python proto2 writer and reader (no generated code, no protobuf
runtime). `COMPAT_PROTO` is the minimal schema, with framework.proto's
field numbers, that the tests compile with protoc when it is present;
framework_compat.proto beside this file is its reviewable copy.
Left out: nothing; attributes other than the two it writes are read
back as strings or ints, as in the JAX package.
"""
from __future__ import annotations

import struct
from typing import Dict, List, Tuple

__all__ = ["serialize_program_desc", "parse_program_desc", "COMPAT_PROTO",
           "REF_TO_LOCAL_OP", "LOCAL_TO_REF_OP"]


# ---------------------------------------------------------------- schema
# Minimal wire-compatible schema (authored for this framework; field
# numbers follow framework.proto:202 — the wire contract).
COMPAT_PROTO = """\
// Wire-compatible subset of the reference ProgramDesc schema
// (framework.proto field numbering). Authored for paddle_tpu; see
// static/proto_io.py for the hand-rolled codec.
syntax = "proto2";
package paddle_tpu.compat;

message Version { optional int64 version = 1 [ default = 0 ]; }

message OpDesc {
  message Attr {
    required string name = 1;
    required int32 type = 2;
    optional int32 i = 3;
    optional float f = 4;
    optional string s = 5;
    repeated int32 ints = 6;
    repeated float floats = 7;
    repeated string strings = 8;
    optional bool b = 10;
    optional int64 l = 13;
    repeated int64 longs = 15;
  }
  message Var {
    required string parameter = 1;
    repeated string arguments = 2;
  }
  repeated Var inputs = 1;
  repeated Var outputs = 2;
  required string type = 3;
  repeated Attr attrs = 4;
}

message VarType {
  message TensorDesc {
    required int32 data_type = 1;
    repeated int64 dims = 2;
  }
  message LoDTensorDesc {
    required TensorDesc tensor = 1;
    optional int32 lod_level = 2 [ default = 0 ];
  }
  required int32 type = 1;
  optional LoDTensorDesc lod_tensor = 3;
}

message VarDesc {
  required string name = 1;
  required VarType type = 2;
  optional bool persistable = 3 [ default = false ];
  optional bool need_check_feed = 4 [ default = false ];
}

message BlockDesc {
  required int32 idx = 1;
  required int32 parent_idx = 2;
  repeated VarDesc vars = 3;
  repeated OpDesc ops = 4;
  optional int32 forward_block_idx = 5 [ default = -1 ];
}

message ProgramDesc {
  repeated BlockDesc blocks = 1;
  optional Version version = 4;
}
"""

# VarType.Type values (framework.proto VarType enum — wire contract)
_DTYPE_TO_CODE = {
    "bool": 0, "int16": 1, "int32": 2, "int64": 3, "float16": 4,
    "float32": 5, "float64": 6, "uint8": 20, "int8": 21, "bfloat16": 22,
}
_CODE_TO_DTYPE = {v: k for k, v in _DTYPE_TO_CODE.items()}
_LOD_TENSOR = 7  # VarType.Type.LOD_TENSOR

# Op-name mapping across the boundary: reference OpDesc type → this
# framework's registry name, for names that differ (the coverage gate in
# tests/test_op_coverage.py documents the full story; only name↔name
# renames matter on the wire). On parse, a type that IS a registered
# local op is kept verbatim — many reference names are also local names.
REF_TO_LOCAL_OP = {
    "batch_norm": "batch_norm_train",
    "pool2d": "pool_max",
    "fill_zeros_like": "zeros_like",
    "fill": "assign_value",
    "lookup_table": "embedding",
    "lookup_table_v2": "embedding",
    "elementwise_add": "add",
    "elementwise_sub": "subtract",
    "elementwise_mul": "multiply",
    "elementwise_div": "divide",
    "reduce_sum": "sum",
    "reduce_mean": "mean",
    "mul": "matmul_v2",
    "matmul": "matmul_v2",
    "top_k": "topk",
    "top_k_v2": "topk",
}
# emit-side renames: ONLY for local names that are not themselves valid
# reference op types (e.g. matmul_v2 is both local and reference, so it
# travels verbatim; pool_max is local-only and emits as pool2d)
LOCAL_TO_REF_OP = {
    "batch_norm_train": "batch_norm",
    "pool_max": "pool2d",
    "topk": "top_k_v2",
    "add": "elementwise_add",
    "subtract": "elementwise_sub",
    "multiply": "elementwise_mul",
    "divide": "elementwise_div",
}


def _is_local_op(name: str) -> bool:
    from ..core.dispatch import registered_ops
    return name in registered_ops()


# ------------------------------------------------------------- wire codec
def _varint(n: int) -> bytes:
    n &= (1 << 64) - 1  # proto2 int64: two's-complement 64-bit varint
    out = bytearray()
    while True:
        b = n & 0x7F
        n >>= 7
        if n:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _tag(field: int, wire_type: int) -> bytes:
    return _varint((field << 3) | wire_type)


def _f_varint(field: int, n: int) -> bytes:
    return _tag(field, 0) + _varint(int(n))


def _f_bytes(field: int, payload: bytes) -> bytes:
    return _tag(field, 2) + _varint(len(payload)) + payload


def _f_str(field: int, s: str) -> bytes:
    return _f_bytes(field, s.encode("utf-8"))


class _Reader:
    def __init__(self, data: bytes):
        self.data = data
        self.pos = 0

    def eof(self) -> bool:
        return self.pos >= len(self.data)

    def varint(self) -> int:
        shift, out = 0, 0
        while True:
            b = self.data[self.pos]
            self.pos += 1
            out |= (b & 0x7F) << shift
            if not b & 0x80:
                return out
            shift += 7

    def signed64(self) -> int:
        v = self.varint()
        return v - (1 << 64) if v >= (1 << 63) else v

    def field(self) -> Tuple[int, int, object]:
        key = self.varint()
        field, wt = key >> 3, key & 7
        if wt == 0:
            return field, wt, self.varint()
        if wt == 2:
            n = self.varint()
            payload = self.data[self.pos:self.pos + n]
            self.pos += n
            return field, wt, payload
        if wt == 5:
            v = struct.unpack_from("<f", self.data, self.pos)[0]
            self.pos += 4
            return field, wt, v
        if wt == 1:
            v = struct.unpack_from("<d", self.data, self.pos)[0]
            self.pos += 8
            return field, wt, v
        raise ValueError(f"unsupported wire type {wt}")


def _fields(data: bytes) -> Dict[int, List]:
    r = _Reader(data)
    out: Dict[int, List] = {}
    while not r.eof():
        f, _, v = r.field()
        out.setdefault(f, []).append(v)
    return out


# ------------------------------------------------------------ serializer
def _tensor_desc(dtype: str, dims) -> bytes:
    code = _DTYPE_TO_CODE.get(str(dtype), 5)
    b = _f_varint(1, code)
    for d in dims:
        b += _f_varint(2, int(d))
    return b


def _var_type(dtype: str, dims) -> bytes:
    lod = _f_bytes(1, _tensor_desc(dtype, dims))
    return _f_varint(1, _LOD_TENSOR) + _f_bytes(3, lod)


def _var_desc(v) -> bytes:
    dtype = str(v.dtype).replace("torch.", "")
    b = _f_str(1, v.name)
    b += _f_bytes(2, _var_type(dtype, v.shape))
    if v.persistable:
        b += _f_varint(3, 1)
    if getattr(v, "is_data", False):
        b += _f_varint(4, 1)  # need_check_feed marks feed vars
    return b


def _op_var(parameter: str, arguments) -> bytes:
    b = _f_str(1, parameter)
    for a in arguments:
        b += _f_str(2, str(a))
    return b


def _op_attr_str(name: str, value: str) -> bytes:
    # Attr{name=1, type=2 (STRING=2), s=5}
    return _f_str(1, name) + _f_varint(2, 2) + _f_str(5, value)


def _op_desc(od) -> bytes:
    # reference slot convention: generic X/Out argument lists
    b = _f_bytes(1, _op_var("X", od.input_names))
    b += _f_bytes(2, _op_var("Out", od.output_names))
    b += _f_str(3, LOCAL_TO_REF_OP.get(od.op_type, od.op_type))
    # record the framework-local kind so round-trips are lossless
    b += _f_bytes(4, _op_attr_str("pd_tpu_kind", od.kind))
    if od.op_type in LOCAL_TO_REF_OP:
        b += _f_bytes(4, _op_attr_str("pd_tpu_op", od.op_type))
    return b


def serialize_program_desc(program) -> bytes:
    """Program → proto2 ProgramDesc bytes (the `__model__` wire format)."""
    blk = _f_varint(1, 0) + _f_varint(2, -1)  # idx=0, parent=-1 (root)
    for v in program.global_block.vars.values():
        blk += _f_bytes(3, _var_desc(v))
    for od in program.ops:
        blk += _f_bytes(4, _op_desc(od))
    out = _f_bytes(1, blk)
    out += _f_bytes(4, _f_varint(1, 0))  # Version{version=0}
    return out


# -------------------------------------------------------------- parser
def _parse_tensor_desc(data: bytes) -> Tuple[str, List[int]]:
    f = _fields(data)
    code = f.get(1, [5])[0]
    dims = []
    for raw in f.get(2, []):
        if isinstance(raw, int):
            dims.append(raw - (1 << 64) if raw >= (1 << 63) else raw)
        else:
            # packed encoding (proto3 default / [packed=true] writers):
            # the repeated int64s arrive as one length-delimited payload
            # of concatenated varints
            r = _Reader(raw)
            while not r.eof():
                dims.append(r.signed64())
    return _CODE_TO_DTYPE.get(code, "float32"), dims


def _parse_var_type(data: bytes) -> Tuple[str, List[int]]:
    f = _fields(data)
    if 3 in f:  # LoDTensorDesc{tensor=1}
        lod = _fields(f[3][0])
        if 1 in lod:
            return _parse_tensor_desc(lod[1][0])
    return "float32", []


def _parse_var_desc(data: bytes) -> dict:
    f = _fields(data)
    dtype, dims = _parse_var_type(f[2][0]) if 2 in f else ("float32", [])
    return {
        "name": f[1][0].decode("utf-8"),
        "dtype": dtype,
        "shape": dims,
        "persistable": bool(f.get(3, [0])[0]),
        "is_data": bool(f.get(4, [0])[0]),
    }


def _parse_op_desc(data: bytes) -> dict:
    f = _fields(data)

    def args(slot_payloads):
        out = []
        for p in slot_payloads:
            sf = _fields(p)
            out.extend(a.decode("utf-8") for a in sf.get(2, []))
        return out

    attrs = {}
    for p in f.get(4, []):
        af = _fields(p)
        name = af[1][0].decode("utf-8")
        if 5 in af:
            attrs[name] = af[5][0].decode("utf-8")
        elif 3 in af:
            attrs[name] = af[3][0]
    ref_type = f[3][0].decode("utf-8")
    if "pd_tpu_op" in attrs:
        local = attrs["pd_tpu_op"]
    elif _is_local_op(ref_type):
        local = ref_type  # shared name: no mapping needed
    else:
        local = REF_TO_LOCAL_OP.get(ref_type, ref_type)
    return {
        "type": local,
        "ref_type": ref_type,
        "kind": attrs.get("pd_tpu_kind", "forward"),
        "inputs": args(f.get(1, [])),
        "outputs": args(f.get(2, [])),
        "attrs": attrs,
    }


def parse_program_desc(data: bytes) -> dict:
    """proto2 ProgramDesc bytes → structural dict (op types mapped back
    through the reference→local rename table)."""
    f = _fields(data)
    if 1 not in f:
        raise ValueError("not a ProgramDesc: no blocks")
    blocks = []
    for braw in f[1]:
        bf = _fields(braw)
        blocks.append({
            "idx": bf.get(1, [0])[0],
            "vars": [_parse_var_desc(p) for p in bf.get(3, [])],
            "ops": [_parse_op_desc(p) for p in bf.get(4, [])],
        })
    version = 0
    if 4 in f:
        vf = _fields(f[4][0])
        version = vf.get(1, [0])[0]
    return {"blocks": blocks, "version": version}
