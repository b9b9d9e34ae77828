"""EVM interpreter + precompiles (reference: core/vm — the go-ethereum
interpreter fork that is the reference's largest functional mass;
SURVEY.md §2.4).

Design: a host-side bytecode interpreter over the flat StateDB (EVM
execution is branchy, serial, and consensus-critical — per SURVEY §7.2
it stays off the accelerator; the card owns the crypto kernels, not the
contract ISA).  Word ops are Python ints masked to 256 bits; state
mutation is recorded in the StateDB undo journal so REVERT/failure
unwinds in O(touched entries), not O(state size) (reference:
core/vm/interpreter.go Run + StateDB journaled snapshots).

Gas: Istanbul-shaped constant table + quadratic memory expansion +
EIP-2929 warm/cold access lists (behind the ``berlin`` switch, on by
default: 2600/2100 cold account/slot, 100 warm, access lists reverted
with their frame) + exact EIP-2200 net SSTORE metering (clean/dirty/
no-op transitions against the tx-start original value, clear refunds
added and unwound, restore refunds, the 2300-stipend sentry) with the
Berlin re-pricing (reset 2900, SLOAD-like 100) when 2929 is on.
Refunds capped at gas_used // 2 (Istanbul rule, as the reference's
chain config uses pre-London gas policy).

Precompiles 0x1-0x9: ecrecover, sha256, ripemd160, identity, modexp,
bn256 add/mul/pairing (crypto_bn256.py — the from-scratch alt_bn128
bigint twin) and blake2f.  Address 252
is the Harmony staking precompile (write-capable: Delegate/Undelegate/
CollectRewards from contract code, beacon shard only — reference:
staking/precompile.go, core/vm/contracts_write.go).

Tracing: pass ``tracer=CallTracer()`` to capture the nested call tree
(debug_traceTransaction callTracer shape).

The port's copy of the JAX package's ``core/vm.py``.
"""

from __future__ import annotations

import hashlib

from ..crypto_ecdsa import pub_to_address, recover
from ..ref.keccak import keccak256
from .. import rlp

WORD = (1 << 256) - 1
SIGN_BIT = 1 << 255
MAX_DEPTH = 1024
MAX_CODE_SIZE = 24576

CREATE_GAS = 32000
CALL_GAS = 700
CALL_VALUE_GAS = 9000
CALL_STIPEND = 2300
NEW_ACCOUNT_GAS = 25000
SSTORE_SET = 20000
SSTORE_UPDATE = 5000
SSTORE_CLEAR_REFUND = 15000
LOG_GAS, LOG_TOPIC_GAS, LOG_DATA_GAS = 375, 375, 8
SHA3_GAS, SHA3_WORD_GAS = 30, 6
COPY_WORD_GAS = 3
MEM_WORD_GAS = 3
EXP_BYTE_GAS = 50
SLOAD_GAS = 800
BALANCE_GAS = 700
EXTCODE_GAS = 700
CODE_DEPOSIT_GAS = 200


class VMError(Exception):
    """Out of gas / stack violation / invalid op — consumes all gas."""


class Revert(Exception):
    def __init__(self, data: bytes):
        self.data = data


class Log:
    __slots__ = ("address", "topics", "data")

    def __init__(self, address, topics, data):
        self.address = address
        self.topics = topics
        self.data = data


class Env:
    """Block-level context (reference: vm.BlockContext)."""

    def __init__(self, block_num=0, timestamp=0, coinbase=b"\x00" * 20,
                 gas_limit=30_000_000, chain_id=1, epoch=0,
                 block_hash_fn=None, shard_id=0):
        self.block_num = block_num
        self.timestamp = timestamp
        self.coinbase = coinbase
        self.gas_limit = gas_limit
        self.chain_id = chain_id
        self.epoch = epoch
        self.shard_id = shard_id
        self.block_hash_fn = block_hash_fn or (lambda n: bytes(32))


def _s256(v: int) -> int:
    return v - (1 << 256) if v & SIGN_BIT else v


def _u256(v: int) -> int:
    return v & WORD


def _addr_word(b: bytes) -> int:
    return int.from_bytes(b, "big")


def _word_addr(v: int) -> bytes:
    return (v & ((1 << 160) - 1)).to_bytes(20, "big")


def _mem_words(n: int) -> int:
    return (n + 31) // 32


class Memory:
    def __init__(self):
        self.data = bytearray()
        self.gas_paid = 0

    def expansion_cost(self, offset: int, size: int) -> int:
        if size == 0:
            return 0
        new_words = _mem_words(offset + size)
        cur_words = _mem_words(len(self.data))
        if new_words <= cur_words:
            return 0
        def cost(w):
            return MEM_WORD_GAS * w + w * w // 512
        return cost(new_words) - cost(cur_words)

    def extend(self, offset: int, size: int):
        if size == 0:
            return
        need = offset + size
        if need > len(self.data):
            self.data.extend(b"\x00" * (need - len(self.data)))

    def read(self, offset: int, size: int) -> bytes:
        if size == 0:
            return b""
        return bytes(self.data[offset:offset + size])

    def write(self, offset: int, blob: bytes):
        self.data[offset:offset + len(blob)] = blob


class Frame:
    """One call frame: stack, memory, pc, gas."""

    def __init__(self, code: bytes, gas: int):
        self.code = code
        self.gas = gas
        self.pc = 0
        self.stack: list[int] = []
        self.mem = Memory()
        self.returndata = b""
        self.jumpdests = _valid_jumpdests(code)

    def use_gas(self, amount: int):
        if amount > self.gas:
            raise VMError("out of gas")
        self.gas -= amount

    def push(self, v: int):
        if len(self.stack) >= 1024:
            raise VMError("stack overflow")
        self.stack.append(v & WORD)

    def pop(self) -> int:
        if not self.stack:
            raise VMError("stack underflow")
        return self.stack.pop()

    def mem_gas(self, offset: int, size: int):
        if size == 0:
            return  # zero-size ops are free no-ops at any offset
        if offset + size > 2 ** 32:
            raise VMError("memory offset too large")
        self.use_gas(self.mem.expansion_cost(offset, size))
        self.mem.extend(offset, size)


def _valid_jumpdests(code: bytes) -> set:
    dests = set()
    i = 0
    while i < len(code):
        op = code[i]
        if op == 0x5B:
            dests.add(i)
        if 0x60 <= op <= 0x7F:
            i += op - 0x5F
        i += 1
    return dests


def create_address(sender: bytes, nonce: int) -> bytes:
    return keccak256(rlp.encode([sender, nonce]))[12:]


def create2_address(sender: bytes, salt: bytes, init_code: bytes) -> bytes:
    return keccak256(
        b"\xff" + sender + salt.rjust(32, b"\x00") + keccak256(init_code)
    )[12:]


# -- precompiles -------------------------------------------------------------

def _pc_ecrecover(data: bytes, gas: int):
    cost = 3000
    if gas < cost:
        raise VMError("precompile oog")
    data = data.ljust(128, b"\x00")[:128]
    h, v = data[:32], int.from_bytes(data[32:64], "big")
    r = data[64:96]
    s = data[96:128]
    if v not in (27, 28):
        return gas - cost, b""
    try:
        pub = recover(h, r + s + bytes([v - 27]))
        return gas - cost, pub_to_address(pub).rjust(32, b"\x00")
    except (ValueError, KeyError):
        return gas - cost, b""


def _pc_sha256(data: bytes, gas: int):
    cost = 60 + 12 * _mem_words(len(data))
    if gas < cost:
        raise VMError("precompile oog")
    return gas - cost, hashlib.sha256(data).digest()


def _pc_ripemd160(data: bytes, gas: int):
    cost = 600 + 120 * _mem_words(len(data))
    if gas < cost:
        raise VMError("precompile oog")
    try:
        h = hashlib.new("ripemd160", data).digest()
    except ValueError as e:  # image without ripemd in OpenSSL
        raise VMError("ripemd160 unavailable") from e
    return gas - cost, h.rjust(32, b"\x00")


def _pc_identity(data: bytes, gas: int):
    cost = 15 + 3 * _mem_words(len(data))
    if gas < cost:
        raise VMError("precompile oog")
    return gas - cost, data


def _pc_modexp(data: bytes, gas: int):
    head = data.ljust(96, b"\x00")
    blen = int.from_bytes(head[:32], "big")
    elen = int.from_bytes(head[32:64], "big")
    mlen = int.from_bytes(head[64:96], "big")
    if blen > 1024 or elen > 1024 or mlen > 1024:
        raise VMError("modexp operand too large")
    body = data[96:].ljust(blen + elen + mlen, b"\x00")
    base = int.from_bytes(body[:blen], "big")
    exp = int.from_bytes(body[blen:blen + elen], "big")
    mod = int.from_bytes(body[blen + elen:blen + elen + mlen], "big")
    words = _mem_words(max(blen, mlen))
    cost = max(200, words * words * max(1, exp.bit_length()) // 3 // 20)
    if gas < cost:
        raise VMError("precompile oog")
    out = b"" if mlen == 0 else (
        (pow(base, exp, mod) if mod else 0).to_bytes(mlen, "big")
    )
    return gas - cost, out


def _bn_g1_from(data: bytes):
    """EIP-196 G1 decode: 64 BE bytes; (0, 0) = infinity; coordinates
    must be < p and on the curve."""
    from .. import crypto_bn256 as BN

    x = int.from_bytes(data[:32], "big")
    y = int.from_bytes(data[32:64], "big")
    if x >= BN.P or y >= BN.P:
        raise VMError("bn256 coordinate out of range")
    if x == 0 and y == 0:
        return None
    pt = (x, y)
    if not BN.g1_on_curve(pt):
        raise VMError("bn256 point not on curve")
    return pt


def _pc_bn256_add(data: bytes, gas: int):
    from .. import crypto_bn256 as BN

    if gas < 150:  # Istanbul (EIP-1108)
        raise VMError("precompile oog")
    data = data.ljust(128, b"\x00")
    out = BN.g1_add(_bn_g1_from(data[:64]), _bn_g1_from(data[64:128]))
    x, y = out if out is not None else (0, 0)
    return gas - 150, x.to_bytes(32, "big") + y.to_bytes(32, "big")


def _pc_bn256_mul(data: bytes, gas: int):
    from .. import crypto_bn256 as BN

    if gas < 6000:
        raise VMError("precompile oog")
    data = data.ljust(96, b"\x00")
    k = int.from_bytes(data[64:96], "big")
    out = BN.g1_mul(_bn_g1_from(data[:64]), k)
    x, y = out if out is not None else (0, 0)
    return gas - 6000, x.to_bytes(32, "big") + y.to_bytes(32, "big")


def _pc_bn256_pairing(data: bytes, gas: int):
    from .. import crypto_bn256 as BN

    if len(data) % 192:
        raise VMError("bn256 pairing input not a multiple of 192")
    k = len(data) // 192
    cost = 45000 + 34000 * k  # Istanbul (EIP-1108)
    if gas < cost:
        raise VMError("precompile oog")
    pairs = []
    for i in range(k):
        chunk = data[i * 192:(i + 1) * 192]
        p = _bn_g1_from(chunk[:64])
        # EIP-197 G2 encoding: x = a*i + b as (a, b), y likewise —
        # imaginary component FIRST
        xi_ = int.from_bytes(chunk[64:96], "big")
        xr = int.from_bytes(chunk[96:128], "big")
        yi = int.from_bytes(chunk[128:160], "big")
        yr = int.from_bytes(chunk[160:192], "big")
        if max(xi_, xr, yi, yr) >= BN.P:
            raise VMError("bn256 coordinate out of range")
        if xi_ == xr == yi == yr == 0:
            q = None
        else:
            q = ((xr, xi_), (yr, yi))
            if not BN.g2_in_subgroup(q):
                raise VMError("bn256 G2 point not in subgroup")
        pairs.append((p, q))
    ok = BN.pairing_check(pairs)
    return gas - cost, (1 if ok else 0).to_bytes(32, "big")


def _pc_blake2f(data: bytes, gas: int):
    import struct

    from ..crypto_bn256 import blake2f

    if len(data) != 213:
        raise VMError("blake2f input must be 213 bytes")
    rounds = int.from_bytes(data[:4], "big")
    if data[212] not in (0, 1):
        raise VMError("blake2f final flag must be 0 or 1")
    if gas < rounds:  # EIP-152: 1 gas per round
        raise VMError("precompile oog")
    h = list(struct.unpack("<8Q", data[4:68]))
    m = list(struct.unpack("<16Q", data[68:196]))
    t = list(struct.unpack("<2Q", data[196:212]))
    out = blake2f(rounds, h, m, t, data[212] == 1)
    return gas - rounds, struct.pack("<8Q", *out)


PRECOMPILES = {
    1: _pc_ecrecover,
    2: _pc_sha256,
    3: _pc_ripemd160,
    4: _pc_identity,
    5: _pc_modexp,
    # alt_bn128 + blake2f (reference: go-ethereum cgo contracts;
    # crypto_bn256.py is the from-scratch bigint twin)
    6: _pc_bn256_add,
    7: _pc_bn256_mul,
    8: _pc_bn256_pairing,
    9: _pc_blake2f,
}


# ----------------------------------------------------------------------
# Harmony staking precompile (write-capable, address 252 — reference:
# staking/precompile.go ParseStakeMsg + core/vm/contracts_write.go
# stakingPrecompile; beacon shard only)
# ----------------------------------------------------------------------

STAKING_PRECOMPILE_ADDR = (252).to_bytes(20, "big")

_SEL_DELEGATE = keccak256(b"Delegate(address,address,uint256)")[:4]
_SEL_UNDELEGATE = keccak256(b"Undelegate(address,address,uint256)")[:4]
_SEL_COLLECT = keccak256(b"CollectRewards(address)")[:4]


def _abi_addr(word: bytes) -> bytes:
    if any(word[:12]):
        raise VMError("malformed ABI address (dirty upper bytes)")
    return word[12:32]


def parse_stake_msg(caller: bytes, data: bytes):
    """Decode the three supported staking methods.  The delegator
    argument MUST equal the calling contract — a contract may only
    stake its own balance (reference: staking/precompile.go:125-131
    ValidateContractAddress)."""
    if len(data) < 4:
        raise VMError("staking precompile: short input")
    sel, body = data[:4], data[4:]
    if sel == _SEL_COLLECT:
        if len(body) != 32:
            raise VMError("staking precompile: bad CollectRewards args")
        delegator = _abi_addr(body[:32])
        if delegator != caller:
            raise VMError("delegator is not the caller")
        return ("collect", delegator, None, 0)
    if sel in (_SEL_DELEGATE, _SEL_UNDELEGATE):
        if len(body) != 96:
            raise VMError("staking precompile: bad (un)delegate args")
        delegator = _abi_addr(body[:32])
        validator = _abi_addr(body[32:64])
        amount = int.from_bytes(body[64:96], "big")
        if delegator != caller:
            raise VMError("delegator is not the caller")
        kind = "delegate" if sel == _SEL_DELEGATE else "undelegate"
        return (kind, delegator, validator, amount)
    raise VMError("staking precompile: unknown selector")


# EIP-2929 access costs (reference: core/vm adopted warm/cold gas;
# applied here behind the ``berlin`` switch)
COLD_ACCOUNT_ACCESS = 2600
COLD_SLOAD = 2100
WARM_ACCESS = 100


class CallTracer:
    """Minimal callTracer-shaped tracer: a nested dict of frames
    (reference: the debug_traceTransaction callTracer of eth/tracers,
    surfaced via rpc).  Attach via EVM(tracer=...); read ``.root``."""

    def __init__(self):
        self.root = None
        self._stack: list[dict] = []

    def enter(self, typ: str, frm: bytes, to: bytes, value: int,
              gas: int, data: bytes):
        node = {
            "type": typ, "from": frm.hex(), "to": to.hex(),
            "value": hex(value), "gas": gas, "input": data.hex(),
            "calls": [],
        }
        if self._stack:
            self._stack[-1]["calls"].append(node)
        else:
            self.root = node
        self._stack.append(node)

    def exit(self, ok: bool, gas_left: int, output: bytes):
        node = self._stack.pop()
        node["gasUsed"] = node["gas"] - gas_left
        node["output"] = output.hex()
        if not ok:
            node["error"] = "execution reverted"


OPCODE_NAMES = {
    0x00: "STOP", 0x01: "ADD", 0x02: "MUL", 0x03: "SUB", 0x04: "DIV",
    0x05: "SDIV", 0x06: "MOD", 0x07: "SMOD", 0x08: "ADDMOD",
    0x09: "MULMOD", 0x0A: "EXP", 0x0B: "SIGNEXTEND", 0x10: "LT",
    0x11: "GT", 0x12: "SLT", 0x13: "SGT", 0x14: "EQ", 0x15: "ISZERO",
    0x16: "AND", 0x17: "OR", 0x18: "XOR", 0x19: "NOT", 0x1A: "BYTE",
    0x1B: "SHL", 0x1C: "SHR", 0x1D: "SAR", 0x20: "SHA3",
    0x30: "ADDRESS", 0x31: "BALANCE", 0x32: "ORIGIN", 0x33: "CALLER",
    0x34: "CALLVALUE", 0x35: "CALLDATALOAD", 0x36: "CALLDATASIZE",
    0x37: "CALLDATACOPY", 0x38: "CODESIZE", 0x39: "CODECOPY",
    0x3A: "GASPRICE", 0x3B: "EXTCODESIZE", 0x3C: "EXTCODECOPY",
    0x3D: "RETURNDATASIZE", 0x3E: "RETURNDATACOPY", 0x3F: "EXTCODEHASH",
    0x40: "BLOCKHASH", 0x41: "COINBASE", 0x42: "TIMESTAMP",
    0x43: "NUMBER", 0x44: "DIFFICULTY", 0x45: "GASLIMIT",
    0x46: "CHAINID", 0x47: "SELFBALANCE", 0x50: "POP", 0x51: "MLOAD",
    0x52: "MSTORE", 0x53: "MSTORE8", 0x54: "SLOAD", 0x55: "SSTORE",
    0x56: "JUMP", 0x57: "JUMPI", 0x58: "PC", 0x59: "MSIZE", 0x5A: "GAS",
    0x5B: "JUMPDEST", 0xF0: "CREATE", 0xF1: "CALL", 0xF2: "CALLCODE",
    0xF3: "RETURN", 0xF4: "DELEGATECALL", 0xF5: "CREATE2",
    0xFA: "STATICCALL", 0xFD: "REVERT", 0xFE: "INVALID",
    0xFF: "SELFDESTRUCT",
    **{0x5F + n: f"PUSH{n}" for n in range(33)},
    **{0x80 + n: f"DUP{n + 1}" for n in range(16)},
    **{0x90 + n: f"SWAP{n + 1}" for n in range(16)},
    **{0xA0 + n: f"LOG{n}" for n in range(5)},
}


class StructLogTracer(CallTracer):
    """The default geth tracer's structLogs (reference: eth/tracers —
    debug_traceTransaction with no tracer option returns opcode-level
    struct logs).  Collects {pc, op, gas, depth, stack} per step, list
    capped so a gas-heavy loop can't OOM the RPC server."""

    def __init__(self, max_steps: int = 50_000, with_stack: bool = True):
        super().__init__()
        self.logs: list[dict] = []
        self.max_steps = max_steps
        self.with_stack = with_stack
        self.truncated = False

    def step(self, pc, op, gas, depth, stack, mem_size):
        if len(self.logs) >= self.max_steps:
            self.truncated = True  # surfaced by the RPC layer: a
            # capped trace must not read as a complete one
            return
        entry = {
            "pc": pc,
            "op": OPCODE_NAMES.get(op, f"opcode 0x{op:02x}"),
            "gas": gas,
            # EVM.depth is incremented before the frame runs, so the
            # top-level call already reads 1 — geth's 1-based depth
            "depth": depth,
            "memSize": mem_size,
        }
        if self.with_stack:
            entry["stack"] = [hex(v) for v in stack]
        self.logs.append(entry)


class NoopTracer(CallTracer):
    """noopTracer: accepts every hook, returns {} — the liveness probe
    tracer (reference: eth/tracers js noop tracer)."""

    @property
    def result(self):
        return {}


class OpcountTracer(CallTracer):
    """opcountTracer: total executed opcode count (reference:
    eth/tracers' opcount JS tracer, served by name)."""

    def __init__(self):
        super().__init__()
        self.count = 0

    def step(self, pc, op, gas, depth, stack, mem_size):
        self.count += 1

    @property
    def result(self):
        return self.count


class FourByteTracer(CallTracer):
    """4byteTracer: function-selector usage — {"0xselector-argsize":
    count} over every call frame carrying >= 4 bytes of input
    (reference: eth/tracers' 4byte tracer output shape)."""

    def __init__(self):
        super().__init__()
        self.ids: dict[str, int] = {}

    def enter(self, typ, frm, to, value, gas, data):
        super().enter(typ, frm, to, value, gas, data)
        if typ != "CREATE" and len(data) >= 4:
            key = f"0x{data[:4].hex()}-{len(data) - 4}"
            self.ids[key] = self.ids.get(key, 0) + 1

    @property
    def result(self):
        return self.ids


class NgramTracer(CallTracer):
    """unigram/bigram/trigramTracer: opcode n-gram histograms
    (reference: eth/tracers' unigram/bigram/trigram JS tracers — the
    profiling family served by name)."""

    def __init__(self, n: int):
        super().__init__()
        self.n = n
        self.hist: dict[str, int] = {}
        self._window: list[str] = []

    def step(self, pc, op, gas, depth, stack, mem_size):
        name = OPCODE_NAMES.get(op, f"0x{op:02x}")
        self._window.append(name)
        if len(self._window) > self.n:
            self._window.pop(0)
        if len(self._window) == self.n:
            key = "-".join(self._window)
            self.hist[key] = self.hist.get(key, 0) + 1

    @property
    def result(self):
        return self.hist


class PrestateTracer(CallTracer):
    """prestateTracer (reference: eth/tracers/native/prestate.go):
    records each touched account's balance/nonce/code and every
    storage slot AS THEY WERE before the transaction — captured on
    first touch via step inspection of state-reading opcodes."""

    def __init__(self, state):
        super().__init__()
        self._state = state
        self.accounts: dict = {}
        self._addr_stack: list[bytes] = []

    def touch(self, addr: bytes):
        """Record an account's pre-tx snapshot on first sight; public
        so the RPC layer can capture the SENDER before the replay's
        nonce bump (enter() only fires after it)."""
        self._touch(addr)

    def _touch(self, addr: bytes):
        key = "0x" + addr.hex()
        if key in self.accounts:
            return
        self.accounts[key] = {
            "balance": hex(self._state.balance(addr)),
            "nonce": self._state.nonce(addr),
            "code": "0x" + self._state.code(addr).hex(),
            "storage": {},
        }

    def _touch_slot(self, addr: bytes, slot: bytes):
        self._touch(addr)
        entry = self.accounts["0x" + addr.hex()]["storage"]
        k = "0x" + slot.hex()
        if k not in entry:
            entry[k] = hex(self._state.storage_get(addr, slot))

    def enter(self, typ, frm, to, value, gas, data):
        super().enter(typ, frm, to, value, gas, data)
        self._touch(frm)
        self._touch(to)
        self._addr_stack.append(to)

    def exit(self, ok, gas_left, output):
        super().exit(ok, gas_left, output)
        self._addr_stack.pop()

    def step(self, pc, op, gas, depth, stack, mem_size):
        if not self._addr_stack or not stack:
            return
        me = self._addr_stack[-1]
        if op in (0x54, 0x55):  # SLOAD/SSTORE: slot on top of stack
            self._touch_slot(me, (stack[-1] % 2**256).to_bytes(32, "big"))
        elif op in (0x31, 0x3B, 0x3C, 0x3F):  # BALANCE/EXTCODE*
            self._touch((stack[-1] % 2**160).to_bytes(20, "big"))
        elif op in (0xF1, 0xF2, 0xF4, 0xFA) and len(stack) >= 2:
            # CALL-family target (2nd from top): covers DELEGATECALL/
            # CALLCODE code accounts, whose frames run under the
            # CALLER's address and so never hit enter()
            self._touch((stack[-2] % 2**160).to_bytes(20, "big"))


class EVM:
    """The interpreter.  One instance per transaction."""

    def __init__(self, state, env: Env, origin: bytes, gas_price: int,
                 berlin: bool = True, tracer: CallTracer | None = None):
        self.state = state
        self.env = env
        self.origin = origin
        self.gas_price = gas_price
        self.logs: list[Log] = []
        self.refund = 0
        self.depth = 0
        self.berlin = berlin
        self.tracer = tracer
        self.stake_msgs: list = []  # applied staking-precompile ops
        # EIP-2200 "original" (tx-start) storage values, captured on
        # first SSTORE touch; tx-scoped, so never reverted with frames
        self._tx_original: dict = {}
        # EIP-2929 access lists: origin + precompiles warm at tx start
        self.warm_addrs: set = {origin} | {
            a.to_bytes(20, "big") for a in PRECOMPILES
        } | {STAKING_PRECOMPILE_ADDR}
        self.warm_slots: set = set()

    # -- EIP-2929 access accounting ----------------------------------------

    def _addr_access_gas(self, addr: bytes) -> int:
        if addr in self.warm_addrs:
            return WARM_ACCESS
        self.warm_addrs.add(addr)
        return COLD_ACCOUNT_ACCESS

    def _slot_access_gas(self, addr: bytes, slot: bytes) -> int:
        key = (addr, slot)
        if key in self.warm_slots:
            return WARM_ACCESS
        self.warm_slots.add(key)
        return COLD_SLOAD

    # -- entry points ------------------------------------------------------

    def call(self, caller: bytes, to: bytes, value: int, data: bytes,
             gas: int, static: bool = False):
        """Message call; returns (ok, gas_left, output)."""
        if self.depth >= MAX_DEPTH:
            return False, gas, b""
        if to == STAKING_PRECOMPILE_ADDR:
            if static:
                return False, 0, b""  # write-capable: no static calls
            snap = self._snapshot()
            if self.tracer:
                self.tracer.enter("CALL", caller, to, value, gas, data)
            # ordinary CALL value semantics apply (the transfer lands
            # on the precompile address and unwinds with the frame)
            if value:
                if self.state.balance(caller) < value:
                    if self.tracer:
                        self.tracer.exit(False, gas, b"")
                    return False, gas, b""
                self.state.sub_balance(caller, value)
                self.state.add_balance(to, value)
            try:
                gas_left, out = self._run_staking_precompile(
                    caller, data, gas
                )
                if self.tracer:
                    self.tracer.exit(True, gas_left, out)
                return True, gas_left, out
            except VMError:
                self._restore(snap)
                if self.tracer:
                    self.tracer.exit(False, 0, b"")
                return False, 0, b""
        fn = PRECOMPILES.get(_addr_word(to))
        if fn is not None:
            snap = self._snapshot()
            if value and not static:
                if self.state.balance(caller) < value:
                    return False, gas, b""
                self.state.sub_balance(caller, value)
                self.state.add_balance(to, value)
            try:
                gas_left, out = fn(data, gas)
                return True, gas_left, out
            except VMError:
                # a failed call has NO state effect — unwind the value
                # transfer too
                self._restore(snap)
                return False, 0, b""
        snap = self._snapshot()
        if self.tracer:
            self.tracer.enter(
                "STATICCALL" if static else "CALL",
                caller, to, value, gas, data,
            )
        if value and not static:
            if self.state.balance(caller) < value:
                if self.tracer:
                    self.tracer.exit(False, gas, b"")
                return False, gas, b""
            self.state.sub_balance(caller, value)
            self.state.add_balance(to, value)
        code = self.state.code(to)
        if not code:
            if self.tracer:
                self.tracer.exit(True, gas, b"")
            return True, gas, b""
        self.depth += 1
        try:
            out, gas_left = self._run(
                code, caller, to, value, data, gas, static
            )
            if self.tracer:
                self.tracer.exit(True, gas_left, out)
            return True, gas_left, out
        except Revert as r:
            self._restore(snap)
            if self.tracer:
                self.tracer.exit(False, r.gas_left, r.data)
            return False, r.gas_left, r.data
        except VMError:
            self._restore(snap)
            if self.tracer:
                self.tracer.exit(False, 0, b"")
            return False, 0, b""
        finally:
            self.depth -= 1

    def create(self, caller: bytes, value: int, init_code: bytes,
               gas: int, salt: bytes | None = None):
        """Contract creation; returns (ok, gas_left, address)."""
        if self.depth >= MAX_DEPTH:
            return False, gas, b""
        if self.state.balance(caller) < value:
            return False, gas, b""
        nonce = self.state.nonce(caller)
        self.state.set_nonce(caller, nonce + 1)
        addr = (
            create2_address(caller, salt, init_code) if salt is not None
            else create_address(caller, nonce)
        )
        if self.state.code(addr) or self.state.nonce(addr):
            return False, 0, b""  # address collision
        snap = self._snapshot()
        if self.tracer:
            self.tracer.enter(
                "CREATE2" if salt is not None else "CREATE",
                caller, addr, value, gas, init_code,
            )
        self.state.sub_balance(caller, value)
        self.state.add_balance(addr, value)
        self.state.set_nonce(addr, 1)
        self.depth += 1
        try:
            code, gas_left = self._run(
                init_code, caller, addr, value, b"", gas, False
            )
            if len(code) > MAX_CODE_SIZE:
                raise VMError("code size limit")
            deposit = CODE_DEPOSIT_GAS * len(code)
            if gas_left < deposit:
                raise VMError("code deposit oog")
            self.state.set_code(addr, code)
            if self.tracer:
                self.tracer.exit(True, gas_left - deposit, code)
            return True, gas_left - deposit, addr
        except Revert as r:
            self._restore(snap)
            if self.tracer:
                self.tracer.exit(False, r.gas_left, r.data)
            return False, r.gas_left, b""
        except VMError:
            self._restore(snap)
            if self.tracer:
                self.tracer.exit(False, 0, b"")
            return False, 0, b""
        finally:
            self.depth -= 1

    # -- staking precompile (write-capable, beacon shard only) -------------

    def _run_staking_precompile(self, caller: bytes, data: bytes,
                                gas: int):
        """Delegate/Undelegate/CollectRewards from contract code
        (reference: core/vm/contracts_write.go RunWriteCapable).  All
        mutations go through journaled StateDB methods — wrappers are
        deep-copied and written back via set_validator so an outer
        REVERT unwinds the staking op too."""
        import copy as _copy

        if self.env.shard_id != 0:
            raise VMError("staking not supported on this shard")
        kind, delegator, validator, amount = parse_stake_msg(caller, data)
        # intrinsic-shaped charge (reference meters IntrinsicGas of the
        # RLP-encoded msg): base tx gas + Istanbul calldata pricing
        cost = 21000 + sum(16 if b else 4 for b in data)
        if gas < cost:
            raise VMError("staking precompile oog")
        gas -= cost
        st = self.state
        if kind == "delegate":
            w = st.validator(validator)
            if w is None:
                raise VMError("no such validator")
            if amount <= 0 or st.balance(delegator) < amount:
                raise VMError("bad delegation amount")
            w = _copy.deepcopy(w)
            if w.max_total_delegation and (
                w.total_delegation() + amount > w.max_total_delegation
            ):
                raise VMError("exceeds max total delegation")
            st.sub_balance(delegator, amount)
            for d in w.delegations:
                if d.delegator == delegator:
                    d.amount += amount
                    break
            else:
                from .state import Delegation

                w.delegations.append(Delegation(delegator, amount))
            st.set_validator(w)
            self.stake_msgs.append((kind, delegator, validator, amount))
        elif kind == "undelegate":
            w = st.validator(validator)
            if w is None:
                raise VMError("no such validator")
            if amount <= 0:
                raise VMError("bad undelegation amount")
            w = _copy.deepcopy(w)
            for d in w.delegations:
                if d.delegator == delegator:
                    if d.amount < amount:
                        raise VMError("undelegate exceeds delegation")
                    d.amount -= amount
                    d.undelegations.append((amount, self.env.epoch))
                    break
            else:
                raise VMError("no delegation to undelegate")
            st.set_validator(w)
            self.stake_msgs.append((kind, delegator, validator, amount))
        else:  # collect
            total = 0
            for addr in st.validator_addresses():
                w = st.validator(addr)
                if not any(
                    d.delegator == delegator and d.reward
                    for d in w.delegations
                ):
                    continue
                w = _copy.deepcopy(w)
                for d in w.delegations:
                    if d.delegator == delegator and d.reward:
                        total += d.reward
                        d.reward = 0
                st.set_validator(w)
            if total == 0:
                raise VMError("no rewards to collect")
            st.add_balance(delegator, total)
            self.stake_msgs.append((kind, delegator, None, total))
        return gas, b""

    # -- state snapshots ---------------------------------------------------

    def _snapshot(self):
        # warm sets are COPIED: EIP-2929 rolls access lists back when a
        # frame reverts
        return (self.state.snapshot(), len(self.logs), self.refund,
                set(self.warm_addrs), set(self.warm_slots))

    def _restore(self, snap):
        mark, n_logs, refund, warm_a, warm_s = snap
        self.state.revert_to(mark)
        del self.logs[n_logs:]
        self.refund = refund
        self.warm_addrs = warm_a
        self.warm_slots = warm_s

    # -- the dispatch loop -------------------------------------------------

    def _run(self, code: bytes, caller: bytes, address: bytes,
             value: int, calldata: bytes, gas: int, static: bool):
        f = Frame(code, gas)
        st, mem = f.stack, f.mem
        # opcode-level tracing is opt-in per tracer (structLog): the
        # attribute probe is hoisted out of the loop — the common
        # CallTracer path must not pay per-opcode overhead
        step = getattr(self.tracer, "step", None)
        while f.pc < len(code):
            op = code[f.pc]
            if step is not None:
                step(f.pc, op, f.gas, self.depth, f.stack,
                     len(f.mem.data))
            f.pc += 1
            # PUSH0..PUSH32
            if 0x5F <= op <= 0x7F:
                n = op - 0x5F
                f.use_gas(2 if n == 0 else 3)
                f.push(int.from_bytes(code[f.pc:f.pc + n], "big"))
                f.pc += n
            elif 0x80 <= op <= 0x8F:  # DUP
                f.use_gas(3)
                n = op - 0x7F
                if len(st) < n:
                    raise VMError("stack underflow")
                f.push(st[-n])
            elif 0x90 <= op <= 0x9F:  # SWAP
                f.use_gas(3)
                n = op - 0x8F
                if len(st) < n + 1:
                    raise VMError("stack underflow")
                st[-1], st[-n - 1] = st[-n - 1], st[-1]
            elif op == 0x01:  # ADD
                f.use_gas(3); f.push(f.pop() + f.pop())
            elif op == 0x02:  # MUL
                f.use_gas(5); f.push(f.pop() * f.pop())
            elif op == 0x03:  # SUB
                f.use_gas(3); a = f.pop(); f.push(a - f.pop())
            elif op == 0x04:  # DIV
                f.use_gas(5); a = f.pop(); b = f.pop()
                f.push(a // b if b else 0)
            elif op == 0x05:  # SDIV
                f.use_gas(5); a = _s256(f.pop()); b = _s256(f.pop())
                f.push(_u256(abs(a) // abs(b) * (1 if (a < 0) == (b < 0) else -1)) if b else 0)
            elif op == 0x06:  # MOD
                f.use_gas(5); a = f.pop(); b = f.pop()
                f.push(a % b if b else 0)
            elif op == 0x07:  # SMOD
                f.use_gas(5); a = _s256(f.pop()); b = _s256(f.pop())
                f.push(_u256(abs(a) % abs(b) * (1 if a >= 0 else -1)) if b else 0)
            elif op == 0x08:  # ADDMOD
                f.use_gas(8); a = f.pop(); b = f.pop(); n = f.pop()
                f.push((a + b) % n if n else 0)
            elif op == 0x09:  # MULMOD
                f.use_gas(8); a = f.pop(); b = f.pop(); n = f.pop()
                f.push((a * b) % n if n else 0)
            elif op == 0x0A:  # EXP
                base = f.pop(); exp = f.pop()
                f.use_gas(10 + EXP_BYTE_GAS * ((exp.bit_length() + 7) // 8))
                f.push(pow(base, exp, 1 << 256))
            elif op == 0x0B:  # SIGNEXTEND
                f.use_gas(5); k = f.pop(); v = f.pop()
                if k < 31:
                    bit = 8 * (k + 1) - 1
                    if v & (1 << bit):
                        v |= WORD ^ ((1 << (bit + 1)) - 1)
                    else:
                        v &= (1 << (bit + 1)) - 1
                f.push(v)
            elif op == 0x10:  # LT
                f.use_gas(3); f.push(1 if f.pop() < f.pop() else 0)
            elif op == 0x11:  # GT
                f.use_gas(3); f.push(1 if f.pop() > f.pop() else 0)
            elif op == 0x12:  # SLT
                f.use_gas(3); f.push(1 if _s256(f.pop()) < _s256(f.pop()) else 0)
            elif op == 0x13:  # SGT
                f.use_gas(3); f.push(1 if _s256(f.pop()) > _s256(f.pop()) else 0)
            elif op == 0x14:  # EQ
                f.use_gas(3); f.push(1 if f.pop() == f.pop() else 0)
            elif op == 0x15:  # ISZERO
                f.use_gas(3); f.push(1 if f.pop() == 0 else 0)
            elif op == 0x16:  # AND
                f.use_gas(3); f.push(f.pop() & f.pop())
            elif op == 0x17:  # OR
                f.use_gas(3); f.push(f.pop() | f.pop())
            elif op == 0x18:  # XOR
                f.use_gas(3); f.push(f.pop() ^ f.pop())
            elif op == 0x19:  # NOT
                f.use_gas(3); f.push(~f.pop())
            elif op == 0x1A:  # BYTE
                f.use_gas(3); i = f.pop(); v = f.pop()
                f.push((v >> (8 * (31 - i))) & 0xFF if i < 32 else 0)
            elif op == 0x1B:  # SHL
                f.use_gas(3); s = f.pop(); v = f.pop()
                f.push(v << s if s < 256 else 0)
            elif op == 0x1C:  # SHR
                f.use_gas(3); s = f.pop(); v = f.pop()
                f.push(v >> s if s < 256 else 0)
            elif op == 0x1D:  # SAR
                f.use_gas(3); s = f.pop(); v = _s256(f.pop())
                f.push(_u256(v >> s if s < 256 else (0 if v >= 0 else -1)))
            elif op == 0x20:  # SHA3
                off = f.pop(); size = f.pop()
                f.use_gas(SHA3_GAS + SHA3_WORD_GAS * _mem_words(size))
                f.mem_gas(off, size)
                f.push(int.from_bytes(keccak256(mem.read(off, size)), "big"))
            elif op == 0x30:  # ADDRESS
                f.use_gas(2); f.push(_addr_word(address))
            elif op == 0x31:  # BALANCE
                a = _word_addr(f.pop())
                f.use_gas(
                    self._addr_access_gas(a) if self.berlin else BALANCE_GAS
                )
                f.push(self.state.balance(a))
            elif op == 0x32:  # ORIGIN
                f.use_gas(2); f.push(_addr_word(self.origin))
            elif op == 0x33:  # CALLER
                f.use_gas(2); f.push(_addr_word(caller))
            elif op == 0x34:  # CALLVALUE
                f.use_gas(2); f.push(value)
            elif op == 0x35:  # CALLDATALOAD
                f.use_gas(3); off = f.pop()
                f.push(int.from_bytes(
                    calldata[off:off + 32].ljust(32, b"\x00"), "big"
                ))
            elif op == 0x36:  # CALLDATASIZE
                f.use_gas(2); f.push(len(calldata))
            elif op == 0x37:  # CALLDATACOPY
                dst = f.pop(); src = f.pop(); size = f.pop()
                f.use_gas(3 + COPY_WORD_GAS * _mem_words(size))
                f.mem_gas(dst, size)
                mem.write(dst, calldata[src:src + size].ljust(size, b"\x00"))
            elif op == 0x38:  # CODESIZE
                f.use_gas(2); f.push(len(code))
            elif op == 0x39:  # CODECOPY
                dst = f.pop(); src = f.pop(); size = f.pop()
                f.use_gas(3 + COPY_WORD_GAS * _mem_words(size))
                f.mem_gas(dst, size)
                mem.write(dst, code[src:src + size].ljust(size, b"\x00"))
            elif op == 0x3A:  # GASPRICE
                f.use_gas(2); f.push(self.gas_price)
            elif op == 0x3B:  # EXTCODESIZE
                a = _word_addr(f.pop())
                f.use_gas(
                    self._addr_access_gas(a) if self.berlin else EXTCODE_GAS
                )
                f.push(len(self.state.code(a)))
            elif op == 0x3C:  # EXTCODECOPY
                addr2 = _word_addr(f.pop())
                dst = f.pop(); src = f.pop(); size = f.pop()
                base = (self._addr_access_gas(addr2) if self.berlin
                        else EXTCODE_GAS)
                f.use_gas(base + COPY_WORD_GAS * _mem_words(size))
                f.mem_gas(dst, size)
                ext = self.state.code(addr2)
                mem.write(dst, ext[src:src + size].ljust(size, b"\x00"))
            elif op == 0x3D:  # RETURNDATASIZE
                f.use_gas(2); f.push(len(f.returndata))
            elif op == 0x3E:  # RETURNDATACOPY
                dst = f.pop(); src = f.pop(); size = f.pop()
                f.use_gas(3 + COPY_WORD_GAS * _mem_words(size))
                if src + size > len(f.returndata):
                    raise VMError("returndata out of bounds")
                f.mem_gas(dst, size)
                mem.write(dst, f.returndata[src:src + size])
            elif op == 0x3F:  # EXTCODEHASH
                a = _word_addr(f.pop())
                f.use_gas(
                    self._addr_access_gas(a) if self.berlin else EXTCODE_GAS
                )
                c = self.state.code(a)
                if not c and not self.state.balance(a) and not self.state.nonce(a):
                    f.push(0)
                else:
                    f.push(int.from_bytes(keccak256(c), "big"))
            elif op == 0x40:  # BLOCKHASH
                f.use_gas(20)
                f.push(int.from_bytes(self.env.block_hash_fn(f.pop()), "big"))
            elif op == 0x41:  # COINBASE
                f.use_gas(2); f.push(_addr_word(self.env.coinbase))
            elif op == 0x42:  # TIMESTAMP
                f.use_gas(2); f.push(self.env.timestamp)
            elif op == 0x43:  # NUMBER
                f.use_gas(2); f.push(self.env.block_num)
            elif op == 0x44:  # DIFFICULTY / PREVRANDAO
                f.use_gas(2); f.push(0)
            elif op == 0x45:  # GASLIMIT
                f.use_gas(2); f.push(self.env.gas_limit)
            elif op == 0x46:  # CHAINID
                f.use_gas(2); f.push(self.env.chain_id)
            elif op == 0x47:  # SELFBALANCE
                f.use_gas(5); f.push(self.state.balance(address))
            elif op == 0x48:  # BASEFEE
                f.use_gas(2); f.push(0)
            elif op == 0x50:  # POP
                f.use_gas(2); f.pop()
            elif op == 0x51:  # MLOAD
                f.use_gas(3); off = f.pop()
                f.mem_gas(off, 32)
                f.push(int.from_bytes(mem.read(off, 32), "big"))
            elif op == 0x52:  # MSTORE
                f.use_gas(3); off = f.pop(); v = f.pop()
                f.mem_gas(off, 32)
                mem.write(off, v.to_bytes(32, "big"))
            elif op == 0x53:  # MSTORE8
                f.use_gas(3); off = f.pop(); v = f.pop()
                f.mem_gas(off, 1)
                mem.write(off, bytes([v & 0xFF]))
            elif op == 0x54:  # SLOAD
                slot = f.pop().to_bytes(32, "big")
                f.use_gas(
                    self._slot_access_gas(address, slot) if self.berlin
                    else SLOAD_GAS
                )
                f.push(self.state.storage_get(address, slot))
            elif op == 0x55:  # SSTORE — exact EIP-2200 net metering
                # (composed with EIP-2929 under berlin, as in the
                # reference's go-ethereum fork: core/vm gas tables)
                if static:
                    raise VMError("SSTORE in static context")
                if f.gas <= CALL_STIPEND:
                    # EIP-2200 sentry: never leave a reentrant call
                    # enough gas to SSTORE out of the stipend
                    raise VMError("SSTORE with gas <= call stipend")
                slot = f.pop().to_bytes(32, "big")
                v = f.pop()
                if self.berlin:
                    if (address, slot) not in self.warm_slots:
                        self.warm_slots.add((address, slot))
                        f.use_gas(COLD_SLOAD)
                key = (address, slot)
                cur = self.state.storage_get(address, slot)
                orig = self._tx_original.setdefault(key, cur)
                # Berlin re-prices the EIP-2200 constants: the
                # SLOAD-like charge becomes the warm access cost and
                # the reset charge drops by the cold surcharge
                sload_like = WARM_ACCESS if self.berlin else SLOAD_GAS
                reset_gas = SSTORE_UPDATE - (
                    COLD_SLOAD if self.berlin else 0
                )
                if v == cur:  # no-op write
                    f.use_gas(sload_like)
                elif cur == orig:  # clean slot: first real write this tx
                    if orig == 0:
                        f.use_gas(SSTORE_SET)
                    else:
                        f.use_gas(reset_gas)
                        if v == 0:
                            self.refund += SSTORE_CLEAR_REFUND
                else:  # dirty slot: rewritten within this tx
                    f.use_gas(sload_like)
                    if orig != 0:
                        if cur == 0:  # resurrecting: undo clear refund
                            self.refund -= SSTORE_CLEAR_REFUND
                        if v == 0:
                            self.refund += SSTORE_CLEAR_REFUND
                    if v == orig:  # restored to tx-start value
                        if orig == 0:
                            self.refund += SSTORE_SET - sload_like
                        else:
                            self.refund += reset_gas - sload_like
                self.state.storage_set(address, slot, v)
            elif op == 0x56:  # JUMP
                f.use_gas(8)
                dest = f.pop()
                if dest not in f.jumpdests:
                    raise VMError("bad jump destination")
                f.pc = dest + 1
            elif op == 0x57:  # JUMPI
                f.use_gas(10)
                dest = f.pop(); cond = f.pop()
                if cond:
                    if dest not in f.jumpdests:
                        raise VMError("bad jump destination")
                    f.pc = dest + 1
            elif op == 0x58:  # PC
                f.use_gas(2); f.push(f.pc - 1)
            elif op == 0x59:  # MSIZE
                f.use_gas(2); f.push(_mem_words(len(mem.data)) * 32)
            elif op == 0x5A:  # GAS
                f.use_gas(2); f.push(f.gas)
            elif op == 0x5B:  # JUMPDEST
                f.use_gas(1)
            elif 0xA0 <= op <= 0xA4:  # LOG0..LOG4
                if static:
                    raise VMError("LOG in static context")
                n = op - 0xA0
                off = f.pop(); size = f.pop()
                topics = [f.pop().to_bytes(32, "big") for _ in range(n)]
                f.use_gas(LOG_GAS + LOG_TOPIC_GAS * n + LOG_DATA_GAS * size)
                f.mem_gas(off, size)
                self.logs.append(Log(address, topics, mem.read(off, size)))
            elif op == 0xF0 or op == 0xF5:  # CREATE / CREATE2
                if static:
                    raise VMError("CREATE in static context")
                val = f.pop(); off = f.pop(); size = f.pop()
                salt = f.pop().to_bytes(32, "big") if op == 0xF5 else None
                f.use_gas(CREATE_GAS)
                if op == 0xF5:
                    f.use_gas(SHA3_WORD_GAS * _mem_words(size))
                f.mem_gas(off, size)
                init = mem.read(off, size)
                child_gas = f.gas - f.gas // 64
                f.use_gas(child_gas)
                ok, gas_left, addr2 = self.create(
                    address, val, init, child_gas, salt
                )
                f.gas += gas_left
                f.returndata = b""
                f.push(_addr_word(addr2) if ok else 0)
            elif op in (0xF1, 0xF2, 0xF4, 0xFA):  # CALL family
                gas_req = f.pop()
                to = _word_addr(f.pop())
                if op in (0xF1, 0xF2):
                    val = f.pop()
                else:
                    val = 0
                in_off = f.pop(); in_size = f.pop()
                out_off = f.pop(); out_size = f.pop()
                if static and op == 0xF1 and val:
                    raise VMError("value call in static context")
                f.use_gas(
                    self._addr_access_gas(to) if self.berlin else CALL_GAS
                )
                if val:
                    f.use_gas(CALL_VALUE_GAS)
                    if op == 0xF1 and not (
                        self.state.nonce(to) or self.state.code(to)
                        or self.state.balance(to)
                    ):
                        f.use_gas(NEW_ACCOUNT_GAS)
                f.mem_gas(in_off, in_size)
                f.mem_gas(out_off, out_size)
                avail = f.gas - f.gas // 64
                child_gas = min(gas_req, avail)
                f.use_gas(child_gas)
                if val:
                    child_gas += CALL_STIPEND
                args = mem.read(in_off, in_size)
                if op == 0xF1:  # CALL
                    ok, gas_left, out = self.call(
                        address, to, val, args, child_gas, static
                    )
                elif op == 0xF2:  # CALLCODE: their code, our storage
                    ok, gas_left, out = self._call_with_code(
                        address, address, to, val, args, child_gas, static
                    )
                elif op == 0xF4:  # DELEGATECALL: keep caller AND value
                    ok, gas_left, out = self._call_with_code(
                        caller, address, to, value, args, child_gas,
                        static, transfer=False,
                    )
                else:  # STATICCALL
                    ok, gas_left, out = self.call(
                        address, to, 0, args, child_gas, True
                    )
                f.gas += gas_left
                f.returndata = out
                mem.write(out_off, out[:out_size].ljust(
                    min(out_size, len(out)), b"\x00"
                ))
                f.push(1 if ok else 0)
            elif op == 0xF3:  # RETURN
                off = f.pop(); size = f.pop()
                f.mem_gas(off, size)
                return mem.read(off, size), f.gas
            elif op == 0xFD:  # REVERT
                off = f.pop(); size = f.pop()
                f.mem_gas(off, size)
                r = Revert(mem.read(off, size))
                r.gas_left = f.gas
                raise r
            elif op == 0xFE:  # INVALID
                raise VMError("invalid opcode")
            elif op == 0xFF:  # SELFDESTRUCT
                if static:
                    raise VMError("SELFDESTRUCT in static context")
                f.use_gas(5000)
                heir = _word_addr(f.pop())
                bal = self.state.balance(address)
                if bal:
                    self.state.sub_balance(address, bal)
                    self.state.add_balance(heir, bal)
                self.state.set_code(address, b"")
                return b"", f.gas
            elif op == 0x00:  # STOP
                return b"", f.gas
            else:
                raise VMError(f"unknown opcode 0x{op:02x}")
        return b"", f.gas

    def _call_with_code(self, caller, storage_addr, code_addr, value,
                        data, gas, static, transfer=True):
        """CALLCODE/DELEGATECALL: run code_addr's code in
        storage_addr's context."""
        if self.depth >= MAX_DEPTH:
            return False, gas, b""
        fn = PRECOMPILES.get(_addr_word(code_addr))
        if fn is not None:
            # precompiles are reachable through every call type; there
            # is no value transfer on this path so no snapshot needed
            try:
                gas_left, out = fn(data, gas)
                return True, gas_left, out
            except VMError:
                return False, 0, b""
        snap = self._snapshot()
        code = self.state.code(code_addr)
        if not code:
            return True, gas, b""
        self.depth += 1
        try:
            out, gas_left = self._run(
                code, caller, storage_addr, value, data, gas, static
            )
            return True, gas_left, out
        except Revert as r:
            self._restore(snap)
            return False, r.gas_left, r.data
        except VMError:
            self._restore(snap)
            return False, 0, b""
        finally:
            self.depth -= 1
