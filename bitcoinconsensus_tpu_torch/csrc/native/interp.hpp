// Verbatim copy of native/interp.hpp, the JAX package's native host core, built by the port's ops/_build.py.
// Native host consensus core: transaction codec, signature hashes
// (legacy / BIP143 / BIP341) and the full script interpreter with the
// deferred-signature seam.
//
// This is the C++ twin of the Python engine in
// `bitcoinconsensus_tpu/core/{tx,serialize,script,sighash,interpreter}.py`
// — same rules, same ScriptError codes (core/script_error.py numbering),
// same deferral protocol (models/batch.py DeferringSignatureChecker).
// The Python engine remains the executable spec; tests/test_native_interp.py
// asserts byte-for-byte agreement across the consensus vectors and random
// scripts. Reference anchors for the rules themselves:
// script/interpreter.cpp:431-1259 (EvalScript), :1937-2056 (VerifyScript),
// :1273-1364/:1577-1642 (legacy sighash), :1581-1625 (BIP143),
// :1491-1574 (BIP341), primitives/transaction.h:187-253 (codec),
// script/script.h:218-391 (CScriptNum).
#pragma once

#include <cstdint>
#include <map>
#include <memory>
#include <set>
#include <stdexcept>
#include <string>
#include <unordered_map>
#include <vector>

#include "hash_extra.hpp"
#include "secp.hpp"
#include "sha256.hpp"

namespace nat {

using Bytes = std::vector<u8>;

// --------------------------------------------------------------------------
// Script error codes: EXACT mirror of core/script_error.py (IntEnum order).
enum ScriptErr : i32 {
    SE_OK = 0,
    SE_UNKNOWN_ERROR,
    SE_EVAL_FALSE,
    SE_OP_RETURN,
    SE_SCRIPT_SIZE,
    SE_PUSH_SIZE,
    SE_OP_COUNT,
    SE_STACK_SIZE,
    SE_SIG_COUNT,
    SE_PUBKEY_COUNT,
    SE_VERIFY,
    SE_EQUALVERIFY,
    SE_CHECKMULTISIGVERIFY,
    SE_CHECKSIGVERIFY,
    SE_NUMEQUALVERIFY,
    SE_BAD_OPCODE,
    SE_DISABLED_OPCODE,
    SE_INVALID_STACK_OPERATION,
    SE_INVALID_ALTSTACK_OPERATION,
    SE_UNBALANCED_CONDITIONAL,
    SE_NEGATIVE_LOCKTIME,
    SE_UNSATISFIED_LOCKTIME,
    SE_SIG_HASHTYPE,
    SE_SIG_DER,
    SE_MINIMALDATA,
    SE_SIG_PUSHONLY,
    SE_SIG_HIGH_S,
    SE_SIG_NULLDUMMY,
    SE_PUBKEYTYPE,
    SE_CLEANSTACK,
    SE_MINIMALIF,
    SE_SIG_NULLFAIL,
    SE_DISCOURAGE_UPGRADABLE_NOPS,
    SE_DISCOURAGE_UPGRADABLE_WITNESS_PROGRAM,
    SE_DISCOURAGE_UPGRADABLE_TAPROOT_VERSION,
    SE_DISCOURAGE_OP_SUCCESS,
    SE_DISCOURAGE_UPGRADABLE_PUBKEYTYPE,
    SE_WITNESS_PROGRAM_WRONG_LENGTH,
    SE_WITNESS_PROGRAM_WITNESS_EMPTY,
    SE_WITNESS_PROGRAM_MISMATCH,
    SE_WITNESS_MALLEATED,
    SE_WITNESS_MALLEATED_P2SH,
    SE_WITNESS_UNEXPECTED,
    SE_WITNESS_PUBKEYTYPE,
    SE_SCHNORR_SIG_SIZE,
    SE_SCHNORR_SIG_HASHTYPE,
    SE_SCHNORR_SIG,
    SE_TAPROOT_WRONG_CONTROL_SIZE,
    SE_TAPSCRIPT_VALIDATION_WEIGHT,
    SE_TAPSCRIPT_CHECKMULTISIG,
    SE_TAPSCRIPT_MINIMALIF,
    SE_OP_CODESEPARATOR,
    SE_SIG_FINDANDDELETE,
};

// Verification flag bits: mirror of core/flags.py / interpreter.h:41-142.
enum : u32 {
    F_P2SH = 1u << 0,
    F_STRICTENC = 1u << 1,
    F_DERSIG = 1u << 2,
    F_LOW_S = 1u << 3,
    F_NULLDUMMY = 1u << 4,
    F_SIGPUSHONLY = 1u << 5,
    F_MINIMALDATA = 1u << 6,
    F_DISCOURAGE_UPGRADABLE_NOPS = 1u << 7,
    F_CLEANSTACK = 1u << 8,
    F_CLTV = 1u << 9,
    F_CSV = 1u << 10,
    F_WITNESS = 1u << 11,
    F_DISCOURAGE_UPGRADABLE_WITNESS_PROGRAM = 1u << 12,
    F_MINIMALIF = 1u << 13,
    F_NULLFAIL = 1u << 14,
    F_WITNESS_PUBKEYTYPE = 1u << 15,
    F_CONST_SCRIPTCODE = 1u << 16,
    F_TAPROOT = 1u << 17,
    F_DISCOURAGE_UPGRADABLE_TAPROOT_VERSION = 1u << 18,
    F_DISCOURAGE_OP_SUCCESS = 1u << 19,
    F_DISCOURAGE_UPGRADABLE_PUBKEYTYPE = 1u << 20,
};

// Consensus limits (script.h:23-56).
constexpr size_t MAX_SCRIPT_ELEMENT_SIZE = 520;
constexpr int MAX_OPS_PER_SCRIPT = 201;
constexpr int MAX_PUBKEYS_PER_MULTISIG = 20;
constexpr size_t MAX_SCRIPT_SIZE = 10000;
constexpr size_t MAX_STACK_SIZE = 1000;
constexpr i64 LOCKTIME_THRESHOLD = 500000000;
constexpr u8 ANNEX_TAG = 0x50;
constexpr i64 VALIDATION_WEIGHT_PER_SIGOP_PASSED = 50;
constexpr i64 VALIDATION_WEIGHT_OFFSET = 50;
constexpr u64 SER_MAX_SIZE = 0x02000000;  // serialize.h MAX_SIZE

// Opcodes used by name below.
enum : int {
    OP_0 = 0x00, OP_PUSHDATA1 = 0x4C, OP_PUSHDATA2 = 0x4D, OP_PUSHDATA4 = 0x4E,
    OP_1NEGATE = 0x4F, OP_RESERVED = 0x50, OP_1 = 0x51, OP_16 = 0x60,
    OP_NOP = 0x61, OP_VER = 0x62, OP_IF = 0x63, OP_NOTIF = 0x64,
    OP_VERIF = 0x65, OP_VERNOTIF = 0x66, OP_ELSE = 0x67, OP_ENDIF = 0x68,
    OP_VERIFY = 0x69, OP_RETURN = 0x6A, OP_TOALTSTACK = 0x6B,
    OP_FROMALTSTACK = 0x6C, OP_2DROP = 0x6D, OP_2DUP = 0x6E, OP_3DUP = 0x6F,
    OP_2OVER = 0x70, OP_2ROT = 0x71, OP_2SWAP = 0x72, OP_IFDUP = 0x73,
    OP_DEPTH = 0x74, OP_DROP = 0x75, OP_DUP = 0x76, OP_NIP = 0x77,
    OP_OVER = 0x78, OP_PICK = 0x79, OP_ROLL = 0x7A, OP_ROT = 0x7B,
    OP_SWAP = 0x7C, OP_TUCK = 0x7D, OP_CAT = 0x7E, OP_SUBSTR = 0x7F,
    OP_LEFT = 0x80, OP_RIGHT = 0x81, OP_SIZE = 0x82, OP_INVERT = 0x83,
    OP_AND = 0x84, OP_OR = 0x85, OP_XOR = 0x86, OP_EQUAL = 0x87,
    OP_EQUALVERIFY = 0x88, OP_RESERVED1 = 0x89, OP_RESERVED2 = 0x8A,
    OP_1ADD = 0x8B, OP_1SUB = 0x8C, OP_2MUL = 0x8D, OP_2DIV = 0x8E,
    OP_NEGATE = 0x8F, OP_ABS = 0x90, OP_NOT = 0x91, OP_0NOTEQUAL = 0x92,
    OP_ADD = 0x93, OP_SUB = 0x94, OP_MUL = 0x95, OP_DIV = 0x96,
    OP_MOD = 0x97, OP_LSHIFT = 0x98, OP_RSHIFT = 0x99, OP_BOOLAND = 0x9A,
    OP_BOOLOR = 0x9B, OP_NUMEQUAL = 0x9C, OP_NUMEQUALVERIFY = 0x9D,
    OP_NUMNOTEQUAL = 0x9E, OP_LESSTHAN = 0x9F, OP_GREATERTHAN = 0xA0,
    OP_LESSTHANOREQUAL = 0xA1, OP_GREATERTHANOREQUAL = 0xA2, OP_MIN = 0xA3,
    OP_MAX = 0xA4, OP_WITHIN = 0xA5, OP_RIPEMD160 = 0xA6, OP_SHA1 = 0xA7,
    OP_SHA256 = 0xA8, OP_HASH160 = 0xA9, OP_HASH256 = 0xAA,
    OP_CODESEPARATOR = 0xAB, OP_CHECKSIG = 0xAC, OP_CHECKSIGVERIFY = 0xAD,
    OP_CHECKMULTISIG = 0xAE, OP_CHECKMULTISIGVERIFY = 0xAF, OP_NOP1 = 0xB0,
    OP_CLTV = 0xB1, OP_CSV = 0xB2, OP_NOP4 = 0xB3, OP_NOP10 = 0xB9,
    OP_CHECKSIGADD = 0xBA,
};

// SigVersion (interpreter.h).
enum : int { SV_BASE = 0, SV_WITNESS_V0 = 1, SV_TAPROOT = 2, SV_TAPSCRIPT = 3 };

// Sighash types.
enum : int {
    SH_DEFAULT = 0, SH_ALL = 1, SH_NONE = 2, SH_SINGLE = 3,
    SH_ANYONECANPAY = 0x80, SH_OUTPUT_MASK = 3, SH_INPUT_MASK = 0x80,
};

constexpr u32 SEQUENCE_FINAL = 0xFFFFFFFFu;
constexpr u32 SEQ_DISABLE = 1u << 31;
constexpr u32 SEQ_TYPE = 1u << 22;
constexpr u32 SEQ_MASK = 0x0000FFFFu;

// Taproot control-block geometry (interpreter.h:214-219).
constexpr u8 TAPROOT_LEAF_MASK = 0xFE;
constexpr u8 TAPROOT_LEAF_TAPSCRIPT = 0xC0;
constexpr size_t TAPROOT_CONTROL_BASE_SIZE = 33;
constexpr size_t TAPROOT_CONTROL_NODE_SIZE = 32;
constexpr size_t TAPROOT_CONTROL_MAX_NODE_COUNT = 128;
constexpr size_t TAPROOT_CONTROL_MAX_SIZE =
    TAPROOT_CONTROL_BASE_SIZE + TAPROOT_CONTROL_NODE_SIZE * TAPROOT_CONTROL_MAX_NODE_COUNT;

// --------------------------------------------------------------------------
// Serialization

struct SerErr : std::runtime_error {
    using std::runtime_error::runtime_error;
};

struct Reader {
    const u8* data;
    size_t len;
    size_t pos = 0;

    Reader(const u8* d, size_t l) : data(d), len(l) {}

    const u8* read(size_t n) {
        if (pos + n > len) throw SerErr("read past end of data");
        const u8* p = data + pos;
        pos += n;
        return p;
    }
    u8 read_u8() { return *read(1); }
    u32 read_u32() {
        const u8* p = read(4);
        return (u32)p[0] | ((u32)p[1] << 8) | ((u32)p[2] << 16) | ((u32)p[3] << 24);
    }
    i32 read_i32() { return (i32)read_u32(); }
    u64 read_u64() {
        const u8* p = read(8);
        u64 v = 0;
        for (int i = 0; i < 8; i++) v |= (u64)p[i] << (8 * i);
        return v;
    }
    i64 read_i64() { return (i64)read_u64(); }
    u64 read_compact_size(bool range_check = true) {
        u8 first = read_u8();
        u64 size;
        if (first < 253) {
            size = first;
        } else if (first == 253) {
            const u8* p = read(2);
            size = (u64)p[0] | ((u64)p[1] << 8);
            if (size < 253) throw SerErr("non-canonical CompactSize");
        } else if (first == 254) {
            size = read_u32();
            if (size < 0x10000) throw SerErr("non-canonical CompactSize");
        } else {
            size = read_u64();
            if (size < 0x100000000ull) throw SerErr("non-canonical CompactSize");
        }
        if (range_check && size > SER_MAX_SIZE) throw SerErr("CompactSize exceeds MAX_SIZE");
        return size;
    }
    Bytes read_string() {
        u64 n = read_compact_size();
        const u8* p = read((size_t)n);
        return Bytes(p, p + n);
    }
};

inline void put_u32(Bytes& b, u32 v) {
    for (int i = 0; i < 4; i++) b.push_back(u8(v >> (8 * i)));
}
inline void put_i64(Bytes& b, i64 v) {
    u64 u = (u64)v;
    for (int i = 0; i < 8; i++) b.push_back(u8(u >> (8 * i)));
}
inline void put_compact_size(Bytes& b, u64 n) {
    if (n < 253) {
        b.push_back(u8(n));
    } else if (n <= 0xFFFF) {
        b.push_back(0xFD);
        b.push_back(u8(n));
        b.push_back(u8(n >> 8));
    } else if (n <= 0xFFFFFFFFull) {
        b.push_back(0xFE);
        put_u32(b, (u32)n);
    } else {
        b.push_back(0xFF);
        put_i64(b, (i64)n);
    }
}
inline void put_bytes(Bytes& b, const Bytes& s) {
    b.insert(b.end(), s.begin(), s.end());
}
inline void put_string(Bytes& b, const Bytes& s) {
    put_compact_size(b, s.size());
    put_bytes(b, s);
}

// --------------------------------------------------------------------------
// Transaction

struct NTxIn {
    u8 prevout_hash[32];
    u32 prevout_n;
    Bytes script_sig;
    u32 sequence;
    std::vector<Bytes> witness;
};

struct NTxOut {
    i64 value;
    Bytes spk;

    Bytes serialize() const {
        Bytes b;
        put_i64(b, value);
        put_string(b, spk);
        return b;
    }
};

struct Precomp {
    bool ready = false;
    bool spent_ready = false;
    bool bip143_ready = false;
    bool bip341_ready = false;
    u8 prevouts_single[32], sequences_single[32], outputs_single[32];
    u8 spent_amounts_single[32], spent_scripts_single[32];
    u8 hash_prevouts[32], hash_sequence[32], hash_outputs[32];
    std::vector<NTxOut> spent_outputs;
    u8 spent_digest[32] = {0};  // cache key over the registered prevouts
};

struct NTx {
    i32 version;
    std::vector<NTxIn> vin;
    std::vector<NTxOut> vout;
    u32 locktime;
    i64 ser_size;  // re-serialized size incl. witness (for the size check)
    Precomp precomp;

    bool has_witness() const {
        for (const auto& in : vin)
            if (!in.witness.empty()) return true;
        return false;
    }

    Bytes serialize(bool include_witness) const {
        bool use_wit = include_witness && has_witness();
        Bytes b;
        put_u32(b, (u32)version);
        if (use_wit) {
            b.push_back(0);
            b.push_back(1);
        }
        put_compact_size(b, vin.size());
        for (const auto& in : vin) {
            b.insert(b.end(), in.prevout_hash, in.prevout_hash + 32);
            put_u32(b, in.prevout_n);
            put_string(b, in.script_sig);
            put_u32(b, in.sequence);
        }
        put_compact_size(b, vout.size());
        for (const auto& out : vout) {
            put_i64(b, out.value);
            put_string(b, out.spk);
        }
        if (use_wit) {
            for (const auto& in : vin) {
                put_compact_size(b, in.witness.size());
                for (const auto& w : in.witness) put_string(b, w);
            }
        }
        put_u32(b, locktime);
        return b;
    }
};

// Exact mirror of UnserializeTransaction (transaction.h:187-224 /
// core/tx.py _deserialize_from). Throws SerErr. Vectors grow
// INCREMENTALLY (one entry per parsed element, each consuming >= 1 input
// byte) — never pre-sized from the attacker-claimed CompactSize, so a
// tiny malformed tx cannot demand a multi-GB allocation.
inline NTx* tx_parse_from(Reader& r) {
    auto tx = std::make_unique<NTx>();
    tx->version = r.read_i32();
    u8 flags = 0;
    u64 n_vin = r.read_compact_size();
    auto read_txin = [&](NTxIn& in) {
        const u8* h = r.read(32);
        std::memcpy(in.prevout_hash, h, 32);
        in.prevout_n = r.read_u32();
        in.script_sig = r.read_string();
        in.sequence = r.read_u32();
    };
    auto read_vin = [&](u64 n) {
        for (u64 i = 0; i < n; i++) {
            tx->vin.emplace_back();
            read_txin(tx->vin.back());
        }
    };
    auto read_vout = [&](u64 n) {
        for (u64 i = 0; i < n; i++) {
            tx->vout.emplace_back();
            tx->vout.back().value = r.read_i64();
            tx->vout.back().spk = r.read_string();
        }
    };
    read_vin(n_vin);
    if (tx->vin.empty()) {
        flags = r.read_u8();
        if (flags != 0) {
            read_vin(r.read_compact_size());
            read_vout(r.read_compact_size());
        }
    } else {
        read_vout(r.read_compact_size());
    }
    if (flags & 1) {
        flags ^= 1;
        bool any = false;
        for (auto& in : tx->vin) {
            u64 n = r.read_compact_size();
            for (u64 i = 0; i < n; i++) in.witness.push_back(r.read_string());
            if (n) any = true;
        }
        if (!any) throw SerErr("Superfluous witness record");
    }
    if (flags) throw SerErr("Unknown transaction optional data");
    tx->locktime = r.read_u32();
    tx->ser_size = (i64)tx->serialize(true).size();
    return tx.release();
}

inline NTx* tx_parse(const u8* data, size_t len) {
    Reader r(data, len);
    return tx_parse_from(r);
}

// --------------------------------------------------------------------------
// Script decoding / predicates (core/script.py twins)

struct Span {
    const u8* p;
    size_t n;
    u8 operator[](size_t i) const { return p[i]; }
    size_t size() const { return n; }
    Span sub(size_t off) const { return {p + off, n - off}; }
    Span sub(size_t off, size_t cnt) const { return {p + off, cnt}; }
};

inline Span span_of(const Bytes& b) { return {b.data(), b.size()}; }

// Decode one op; returns false on truncated push (opcode -> -1).
inline bool decode_op(Span s, size_t& pos, int& opcode, const u8** data,
                      size_t* dlen) {
    opcode = s[pos];
    pos += 1;
    *data = nullptr;
    *dlen = 0;
    if (opcode > OP_PUSHDATA4) return true;
    u64 size;
    if (opcode < OP_PUSHDATA1) {
        size = (u64)opcode;
    } else if (opcode == OP_PUSHDATA1) {
        if (pos + 1 > s.size()) return false;
        size = s[pos];
        pos += 1;
    } else if (opcode == OP_PUSHDATA2) {
        if (pos + 2 > s.size()) return false;
        size = (u64)s[pos] | ((u64)s[pos + 1] << 8);
        pos += 2;
    } else {
        if (pos + 4 > s.size()) return false;
        size = (u64)s[pos] | ((u64)s[pos + 1] << 8) | ((u64)s[pos + 2] << 16) |
               ((u64)s[pos + 3] << 24);
        pos += 4;
    }
    if (pos + size > s.size()) return false;
    *data = s.p + pos;
    *dlen = (size_t)size;
    pos += (size_t)size;
    return true;
}

inline Bytes push_data_enc(const Bytes& d) {
    Bytes out;
    size_t n = d.size();
    if (n < OP_PUSHDATA1) {
        out.push_back(u8(n));
    } else if (n <= 0xFF) {
        out.push_back(OP_PUSHDATA1);
        out.push_back(u8(n));
    } else if (n <= 0xFFFF) {
        out.push_back(OP_PUSHDATA2);
        out.push_back(u8(n));
        out.push_back(u8(n >> 8));
    } else {
        out.push_back(OP_PUSHDATA4);
        put_u32(out, (u32)n);
    }
    put_bytes(out, d);
    return out;
}

inline bool check_minimal_push(const u8* d, size_t n, int opcode) {
    if (n == 0) return opcode == OP_0;
    if (n == 1 && d[0] >= 1 && d[0] <= 16) return false;
    if (n == 1 && d[0] == 0x81) return false;
    if (n <= 75) return opcode == (int)n;
    if (n <= 255) return opcode == OP_PUSHDATA1;
    if (n <= 65535) return opcode == OP_PUSHDATA2;
    return true;
}

inline bool is_p2sh(const Bytes& s) {
    return s.size() == 23 && s[0] == OP_HASH160 && s[1] == 0x14 && s[22] == OP_EQUAL;
}

inline bool is_witness_program(const Bytes& s, int* version, Bytes* program) {
    if (s.size() < 4 || s.size() > 42) return false;
    if (s[0] != OP_0 && !(s[0] >= OP_1 && s[0] <= OP_16)) return false;
    if ((size_t)s[1] + 2 != s.size()) return false;
    *version = s[0] == OP_0 ? 0 : s[0] - OP_1 + 1;
    program->assign(s.begin() + 2, s.end());
    return true;
}

inline bool is_push_only(const Bytes& s) {
    Span sp = span_of(s);
    size_t pos = 0;
    while (pos < sp.size()) {
        int opcode;
        const u8* d;
        size_t dl;
        if (!decode_op(sp, pos, opcode, &d, &dl)) return false;
        if (opcode > OP_16) return false;
    }
    return true;
}

inline bool is_op_success(int op) {
    return op == 0x50 || op == 0x62 || (0x7E <= op && op <= 0x81) ||
           (0x83 <= op && op <= 0x86) || (0x89 <= op && op <= 0x8A) ||
           (0x8D <= op && op <= 0x8E) || (0x95 <= op && op <= 0x99) ||
           (0xBB <= op && op <= 0xFE);
}

// FindAndDelete (core/script.py find_and_delete semantics).
inline int find_and_delete(Bytes& script, const Bytes& needle) {
    if (needle.empty()) return 0;
    Bytes out;
    int n_found = 0;
    Span sp = span_of(script);
    size_t pos = 0, last = 0;
    while (pos < sp.size()) {
        out.insert(out.end(), sp.p + last, sp.p + pos);
        while (pos + needle.size() <= sp.size() &&
               std::memcmp(sp.p + pos, needle.data(), needle.size()) == 0) {
            pos += needle.size();
            n_found++;
        }
        last = pos;
        if (pos < sp.size()) {
            int opcode;
            const u8* d;
            size_t dl;
            if (!decode_op(sp, pos, opcode, &d, &dl)) break;
        } else {
            break;
        }
    }
    out.insert(out.end(), sp.p + last, sp.p + sp.size());
    if (n_found) script = out;
    return n_found;
}

// --------------------------------------------------------------------------
// CScriptNum

struct ScriptNumErr : std::runtime_error {
    using std::runtime_error::runtime_error;
};

inline i64 script_num_decode(const Bytes& d, bool require_minimal,
                             size_t max_size = 4) {
    if (d.size() > max_size) throw ScriptNumErr("script number overflow");
    if (require_minimal && !d.empty()) {
        if ((d.back() & 0x7F) == 0) {
            if (d.size() <= 1 || !(d[d.size() - 2] & 0x80))
                throw ScriptNumErr("non-minimally encoded script number");
        }
    }
    if (d.empty()) return 0;
    u64 result = 0;
    for (size_t i = 0; i < d.size(); i++) result |= (u64)d[i] << (8 * i);
    if (d.back() & 0x80) {
        result &= ~((u64)0x80 << (8 * (d.size() - 1)));
        return -(i64)result;
    }
    return (i64)result;
}

inline Bytes script_num_encode(i64 n) {
    Bytes out;
    if (n == 0) return out;
    bool negative = n < 0;
    u64 absvalue = negative ? (u64)(-(n + 1)) + 1 : (u64)n;
    while (absvalue) {
        out.push_back(u8(absvalue & 0xFF));
        absvalue >>= 8;
    }
    if (out.back() & 0x80) {
        out.push_back(negative ? 0x80 : 0x00);
    } else if (negative) {
        out.back() |= 0x80;
    }
    return out;
}

inline bool script_num_to_bool(const Bytes& d) {
    for (size_t i = 0; i < d.size(); i++) {
        if (d[i] != 0) return !(i == d.size() - 1 && d[i] == 0x80);
    }
    return false;
}

inline i64 clamp_int(i64 v) {
    if (v > 0x7FFFFFFFll) return 0x7FFFFFFFll;
    if (v < -0x80000000ll) return -0x80000000ll;
    return v;
}

// --------------------------------------------------------------------------
// Sighash

inline const TagMidstate& TAG_TAPSIGHASH() {
    static TagMidstate t("TapSighash");
    return t;
}
inline const TagMidstate& TAG_TAPLEAF() {
    static TagMidstate t("TapLeaf");
    return t;
}
inline const TagMidstate& TAG_TAPBRANCH() {
    static TagMidstate t("TapBranch");
    return t;
}
inline const TagMidstate& TAG_TAPTWEAK() {
    static TagMidstate t("TapTweak");
    return t;
}

// SerializeScriptCode (core/sighash.py _serialize_script_code semantics).
inline Bytes serialize_script_code(const Bytes& sc) {
    Span sp = span_of(sc);
    size_t n_codeseps = 0;
    size_t pos = 0;
    while (pos < sp.size()) {
        int opcode;
        const u8* d;
        size_t dl;
        if (!decode_op(sp, pos, opcode, &d, &dl)) break;
        if (opcode == OP_CODESEPARATOR) n_codeseps++;
    }
    Bytes out;
    put_compact_size(out, sc.size() - n_codeseps);
    size_t seg_start = 0;
    pos = 0;
    while (pos < sp.size()) {
        int opcode;
        const u8* d;
        size_t dl;
        size_t before = pos;
        if (!decode_op(sp, pos, opcode, &d, &dl)) {
            // truncated push: decoder consumed opcode/length bytes only;
            // write the segment up to that point, drop the tail.
            (void)before;
            out.insert(out.end(), sp.p + seg_start, sp.p + pos);
            return out;
        }
        if (opcode == OP_CODESEPARATOR) {
            out.insert(out.end(), sp.p + seg_start, sp.p + pos - 1);
            seg_start = pos;
        }
    }
    if (seg_start != sp.size()) out.insert(out.end(), sp.p + seg_start, sp.p + sp.size());
    return out;
}

inline void legacy_sighash(const Bytes& script_code, const NTx& tx, size_t n_in,
                           int hash_type, u8 out[32]) {
    bool anyone = (hash_type & SH_ANYONECANPAY) != 0;
    int base = hash_type & 0x1F;
    bool hash_single = base == SH_SINGLE;
    bool hash_none = base == SH_NONE;
    if (hash_single && n_in >= tx.vout.size()) {
        std::memset(out, 0, 32);
        out[0] = 1;
        return;
    }
    Bytes s;
    put_u32(s, (u32)tx.version);
    size_t n_inputs = anyone ? 1 : tx.vin.size();
    put_compact_size(s, n_inputs);
    for (size_t k = 0; k < n_inputs; k++) {
        size_t i = anyone ? n_in : k;
        const NTxIn& txin = tx.vin[i];
        s.insert(s.end(), txin.prevout_hash, txin.prevout_hash + 32);
        put_u32(s, txin.prevout_n);
        if (i != n_in) {
            put_compact_size(s, 0);
        } else {
            Bytes ssc = serialize_script_code(script_code);
            put_bytes(s, ssc);
        }
        if (i != n_in && (hash_single || hash_none)) {
            put_u32(s, 0);
        } else {
            put_u32(s, txin.sequence);
        }
    }
    size_t n_outputs;
    if (hash_none) n_outputs = 0;
    else if (hash_single) n_outputs = n_in + 1;
    else n_outputs = tx.vout.size();
    put_compact_size(s, n_outputs);
    for (size_t i = 0; i < n_outputs; i++) {
        if (hash_single && i != n_in) {
            put_i64(s, -1);
            put_compact_size(s, 0);
        } else {
            put_i64(s, tx.vout[i].value);
            put_string(s, tx.vout[i].spk);
        }
    }
    put_u32(s, tx.locktime);
    put_u32(s, (u32)(i32)hash_type);
    sha256d(s.data(), s.size(), out);
}

// Compute the tx-wide single-SHA aggregates + BIP143 doubles; spent
// aggregates when spent outputs are registered (interpreter.cpp:1422-1472).
inline void precompute(NTx& tx, const std::vector<NTxOut>* spent) {
    Precomp& pc = tx.precomp;
    pc = Precomp();
    pc.ready = true;
    // A prevout list is only usable when it has exactly one entry per
    // input (interpreter.cpp:1512 readiness contract); a wrong-length
    // list is ignored rather than indexed out of bounds.
    if (spent && spent->size() == tx.vin.size()) {
        pc.spent_outputs = *spent;
        pc.spent_ready = true;
    }
    bool uses143 = false, uses341 = false;
    for (size_t i = 0; i < tx.vin.size(); i++) {
        if (uses143 && uses341) break;
        if (!tx.vin[i].witness.empty()) {
            const Bytes* spk =
                pc.spent_ready ? &pc.spent_outputs[i].spk : nullptr;
            if (spk && spk->size() == 34 && (*spk)[0] == OP_1) uses341 = true;
            else uses143 = true;
        }
    }
    if (uses143 || uses341) {
        Bytes b;
        for (const auto& in : tx.vin) {
            b.insert(b.end(), in.prevout_hash, in.prevout_hash + 32);
            put_u32(b, in.prevout_n);
        }
        sha256(b.data(), b.size(), pc.prevouts_single);
        b.clear();
        for (const auto& in : tx.vin) put_u32(b, in.sequence);
        sha256(b.data(), b.size(), pc.sequences_single);
        b.clear();
        for (const auto& out : tx.vout) {
            put_i64(b, out.value);
            put_string(b, out.spk);
        }
        sha256(b.data(), b.size(), pc.outputs_single);
    }
    if (uses143) {
        sha256(pc.prevouts_single, 32, pc.hash_prevouts);
        sha256(pc.sequences_single, 32, pc.hash_sequence);
        sha256(pc.outputs_single, 32, pc.hash_outputs);
        pc.bip143_ready = true;
    }
    if (uses341 && pc.spent_ready) {
        Bytes b;
        for (const auto& out : pc.spent_outputs) put_i64(b, out.value);
        sha256(b.data(), b.size(), pc.spent_amounts_single);
        b.clear();
        for (const auto& out : pc.spent_outputs) put_string(b, out.spk);
        sha256(b.data(), b.size(), pc.spent_scripts_single);
        pc.bip341_ready = true;
    }
}

inline void bip143_sighash(const Bytes& script_code, const NTx& tx, size_t n_in,
                           int hash_type, i64 amount, u8 out[32]) {
    const Precomp& pc = tx.precomp;
    bool cacheready = pc.ready && pc.bip143_ready;
    u8 hash_prevouts[32] = {0}, hash_sequence[32] = {0}, hash_outputs[32] = {0};
    int base = hash_type & 0x1F;
    if (!(hash_type & SH_ANYONECANPAY)) {
        if (cacheready) {
            std::memcpy(hash_prevouts, pc.hash_prevouts, 32);
        } else {
            Bytes b;
            for (const auto& in : tx.vin) {
                b.insert(b.end(), in.prevout_hash, in.prevout_hash + 32);
                put_u32(b, in.prevout_n);
            }
            sha256d(b.data(), b.size(), hash_prevouts);
        }
    }
    if (!(hash_type & SH_ANYONECANPAY) && base != SH_SINGLE && base != SH_NONE) {
        if (cacheready) {
            std::memcpy(hash_sequence, pc.hash_sequence, 32);
        } else {
            Bytes b;
            for (const auto& in : tx.vin) put_u32(b, in.sequence);
            sha256d(b.data(), b.size(), hash_sequence);
        }
    }
    if (base != SH_SINGLE && base != SH_NONE) {
        if (cacheready) {
            std::memcpy(hash_outputs, pc.hash_outputs, 32);
        } else {
            Bytes b;
            for (const auto& out : tx.vout) {
                put_i64(b, out.value);
                put_string(b, out.spk);
            }
            sha256d(b.data(), b.size(), hash_outputs);
        }
    } else if (base == SH_SINGLE && n_in < tx.vout.size()) {
        Bytes b = tx.vout[n_in].serialize();
        sha256d(b.data(), b.size(), hash_outputs);
    }
    Bytes s;
    put_u32(s, (u32)tx.version);
    s.insert(s.end(), hash_prevouts, hash_prevouts + 32);
    s.insert(s.end(), hash_sequence, hash_sequence + 32);
    s.insert(s.end(), tx.vin[n_in].prevout_hash, tx.vin[n_in].prevout_hash + 32);
    put_u32(s, tx.vin[n_in].prevout_n);
    put_string(s, script_code);
    put_i64(s, amount);
    put_u32(s, tx.vin[n_in].sequence);
    s.insert(s.end(), hash_outputs, hash_outputs + 32);
    put_u32(s, tx.locktime);
    put_u32(s, (u32)(i32)hash_type);
    sha256d(s.data(), s.size(), out);
}

// Returns false on invalid hash type / SINGLE out of range.
inline bool bip341_sighash(const NTx& tx, size_t n_in, int hash_type,
                           int sigversion, bool annex_present,
                           const u8* annex_hash, const Bytes& tapleaf_hash,
                           u32 codeseparator_pos, u8 out[32]) {
    const Precomp& pc = tx.precomp;
    int ext_flag = sigversion == SV_TAPSCRIPT ? 1 : 0;
    Bytes s;
    s.push_back(0);  // epoch
    int output_type = hash_type == SH_DEFAULT ? SH_ALL : (hash_type & SH_OUTPUT_MASK);
    int input_type = hash_type & SH_INPUT_MASK;
    if (!(hash_type <= 0x03 || (hash_type >= 0x81 && hash_type <= 0x83)))
        return false;
    s.push_back(u8(hash_type));
    put_u32(s, (u32)tx.version);
    put_u32(s, tx.locktime);
    if (input_type != SH_ANYONECANPAY) {
        s.insert(s.end(), pc.prevouts_single, pc.prevouts_single + 32);
        s.insert(s.end(), pc.spent_amounts_single, pc.spent_amounts_single + 32);
        s.insert(s.end(), pc.spent_scripts_single, pc.spent_scripts_single + 32);
        s.insert(s.end(), pc.sequences_single, pc.sequences_single + 32);
    }
    if (output_type == SH_ALL)
        s.insert(s.end(), pc.outputs_single, pc.outputs_single + 32);
    u8 spend_type = u8((ext_flag << 1) + (annex_present ? 1 : 0));
    s.push_back(spend_type);
    if (input_type == SH_ANYONECANPAY) {
        s.insert(s.end(), tx.vin[n_in].prevout_hash, tx.vin[n_in].prevout_hash + 32);
        put_u32(s, tx.vin[n_in].prevout_n);
        Bytes so = pc.spent_outputs[n_in].serialize();
        put_bytes(s, so);
        put_u32(s, tx.vin[n_in].sequence);
    } else {
        put_u32(s, (u32)n_in);
    }
    if (annex_present) s.insert(s.end(), annex_hash, annex_hash + 32);
    if (output_type == SH_SINGLE) {
        if (n_in >= tx.vout.size()) return false;
        Bytes ob = tx.vout[n_in].serialize();
        u8 oh[32];
        sha256(ob.data(), ob.size(), oh);
        s.insert(s.end(), oh, oh + 32);
    }
    if (sigversion == SV_TAPSCRIPT) {
        s.insert(s.end(), tapleaf_hash.begin(), tapleaf_hash.end());
        s.push_back(0);  // key_version
        put_u32(s, codeseparator_pos);
    }
    TAG_TAPSIGHASH().hash(s.data(), s.size(), out);
    return true;
}

// --------------------------------------------------------------------------
// Checker with the deferral seam (models/batch.py DeferringSignatureChecker
// + core/interpreter.py TransactionSignatureChecker semantics).

struct Record {
    int kind;  // 0 ecdsa, 1 schnorr, 2 tweak
    int parity;
    Bytes p0, p1, p2;  // ecdsa: pubkey|sig|msg; schnorr: pk32|sig64|msg;
                       // tweak: q32|internal32|tweak32
};

struct Session {
    std::map<std::string, bool> known;
    std::vector<Record> records;
    // --- Index-mode (session-resident uniq protocol) -----------------
    // The batch driver's fast path: instead of draining full record
    // bytes to Python, deduping there, and shipping them back for
    // digesting/lane-prep/publishing, the session keeps ONE deduped
    // check list (`uniq`, discovery order) and each verify call emits
    // only int32 indices into it (`rec_idx`). Lanes, cache digests and
    // verdict publication all read uniq in place — zero byte round-trips
    // across the ctypes bridge (the round-3 profile showed ~200 ms of a
    // 3.2k-input block replay in exactly that shuffling).
    bool index_mode = false;
    std::vector<Record> uniq;
    std::vector<std::string> uniq_keys;  // parallel: known-map key per uniq
    std::unordered_map<std::string, i32> uniq_seen;  // key -> uniq index
    std::vector<i32> rec_idx;  // per-call flat index stream
    // Read-only oracle for worker-scratch sessions (checkqueue.h analogue:
    // the threaded interpretation shards share the main session's known
    // map; scratch sessions collect records locally and merge serially).
    const Session* oracle = nullptr;

    const std::map<std::string, bool>& known_view() const {
        return oracle ? oracle->known : known;
    }

    // Record an oracle miss in index mode: dedup into uniq, emit index.
    void index_record(std::string&& k, int kind, int parity, const Bytes& a,
                      const Bytes& b, const Bytes& c) {
        auto ins = uniq_seen.try_emplace(std::move(k), (i32)uniq.size());
        if (ins.second) {
            uniq.push_back(Record{kind, parity, a, b, c});
            uniq_keys.push_back(ins.first->first);
        }
        rec_idx.push_back(ins.first->second);
    }
    // Speculative CHECKMULTISIG pairings: every (sig, key) pair the cursor
    // walk could reach (key-index minus sig-index in [0, nkeys-nsigs]) is
    // pre-recorded here so ONE device dispatch answers every oracle read a
    // re-interpretation can make — misaligned multisig resolves without a
    // second host->device round-trip. Kept apart from `records` so the
    // optimistic-verdict judgment stays exact (a false speculative pair
    // must not reject a verdict whose own checks all held).
    std::vector<Record> spec;
    std::set<std::string> spec_seen;
    int unknown = 0;

    static std::string key(int kind, int parity, const Bytes& a, const Bytes& b,
                           const Bytes& c) {
        std::string k;
        k.push_back(char(kind));
        k.push_back(char(parity));
        auto add = [&](const Bytes& v) {
            u64 n = v.size();
            for (int i = 0; i < 8; i++) k.push_back(char(u8(n >> (8 * i))));
            k.append(reinterpret_cast<const char*>(v.data()), v.size());
        };
        add(a);
        add(b);
        add(c);
        return k;
    }
};

struct ExecData {
    bool annex_present = false;
    u8 annex_hash[32] = {0};
    bool tapleaf_hash_init = false;
    Bytes tapleaf_hash;
    u32 codeseparator_pos = 0xFFFFFFFF;
    bool validation_weight_left_init = false;
    i64 validation_weight_left = 0;
};

enum : int { MODE_DEFER = 0, MODE_EXACT = 1 };

struct Checker {
    const NTx* tx;
    size_t n_in;
    i64 amount;
    int mode;
    Session* sess;  // used in MODE_DEFER

    // raw curve resolution: oracle -> record-optimistic (defer) or native
    // verify (exact)
    bool resolve(int kind, int parity, const Bytes& a, const Bytes& b,
                 const Bytes& c) {
        if (mode == MODE_EXACT) {
            if (kind == 0)
                return verify_ecdsa(a.data(), a.size(), b.data(), b.size(), c.data());
            if (kind == 1) return verify_schnorr(a.data(), b.data(), c.data());
            return tweak_add_check(a.data(), parity, b.data(), c.data());
        }
        std::string k = Session::key(kind, parity, a, b, c);
        const auto& known = sess->known_view();
        auto it = known.find(k);
        if (it != known.end()) return it->second;
        sess->unknown++;
        if (sess->index_mode)
            sess->index_record(std::move(k), kind, parity, a, b, c);
        else
            sess->records.push_back(Record{kind, parity, a, b, c});
        return true;
    }

    // Structural early-false gates shared by check and speculate: a sig/key
    // failing these never reaches the curve, so there is nothing to defer.
    static bool pubkey_plausible(const Bytes& pubkey) {
        if (pubkey.empty()) return false;
        u8 p0 = pubkey[0];
        if (p0 == 2 || p0 == 3) return pubkey.size() == 33;
        if (p0 == 4 || p0 == 6 || p0 == 7) return pubkey.size() == 65;
        return false;
    }

    static bool ec_check_plausible(const Bytes& sig, const Bytes& pubkey) {
        return !sig.empty() && pubkey_plausible(pubkey);
    }

    void ecdsa_sighash(const Bytes& sig, const Bytes& script_code,
                       int sigversion, Bytes* sig_body, Bytes* msg) {
        int hash_type = sig.back();
        sig_body->assign(sig.begin(), sig.end() - 1);
        u8 sighash[32];
        if (sigversion == SV_WITNESS_V0) {
            bip143_sighash(script_code, *tx, n_in, hash_type, amount, sighash);
        } else {
            legacy_sighash(script_code, *tx, n_in, hash_type, sighash);
        }
        msg->assign(sighash, sighash + 32);
    }

    bool check_ecdsa_signature(const Bytes& sig, const Bytes& pubkey,
                               const Bytes& script_code, int sigversion) {
        if (!ec_check_plausible(sig, pubkey)) return false;
        Bytes sig_body, msg;
        ecdsa_sighash(sig, script_code, sigversion, &sig_body, &msg);
        return resolve(0, 0, pubkey, sig_body, msg);
    }

    // Speculative CHECKMULTISIG pre-recording, split so the sighash (a
    // function of the sig's hash_type only, not the key) is computed ONCE
    // per sig: prep yields (sig_body, msg), then record per reachable key.
    bool speculate_ecdsa_prep(const Bytes& sig, const Bytes& script_code,
                              int sigversion, Bytes* sig_body, Bytes* msg) {
        if (mode != MODE_DEFER || !sess) return false;
        if (sig.empty()) return false;
        ecdsa_sighash(sig, script_code, sigversion, sig_body, msg);
        return true;
    }

    void speculate_ecdsa_record(const Bytes& pubkey, const Bytes& sig_body,
                                const Bytes& msg) {
        if (!pubkey_plausible(pubkey)) return;
        std::string k = Session::key(0, 0, pubkey, sig_body, msg);
        if (sess->known_view().count(k)) return;
        if (sess->index_mode) {
            // Resolve-only: dedup into uniq WITHOUT emitting a rec_idx
            // entry, so a speculative pair can never affect an
            // optimistic verdict (same contract as the spec vector).
            auto ins = sess->uniq_seen.try_emplace(std::move(k),
                                                   (i32)sess->uniq.size());
            if (ins.second) {
                sess->uniq.push_back(Record{0, 0, pubkey, sig_body, msg});
                sess->uniq_keys.push_back(ins.first->first);
            }
            return;
        }
        if (!sess->spec_seen.insert(k).second) return;
        sess->spec.push_back(Record{0, 0, pubkey, sig_body, msg});
    }

    // returns ok; on hard failure sets *err
    bool check_schnorr_signature(const Bytes& sig_in, const Bytes& pubkey,
                                 int sigversion, ExecData& execdata, i32* err) {
        Bytes sig = sig_in;
        if (sig.size() != 64 && sig.size() != 65) {
            *err = SE_SCHNORR_SIG_SIZE;
            return false;
        }
        int hash_type = SH_DEFAULT;
        if (sig.size() == 65) {
            hash_type = sig.back();
            sig.pop_back();
            if (hash_type == SH_DEFAULT) {
                *err = SE_SCHNORR_SIG_HASHTYPE;
                return false;
            }
        }
        u8 sighash[32];
        if (!bip341_sighash(*tx, n_in, hash_type, sigversion,
                            execdata.annex_present, execdata.annex_hash,
                            execdata.tapleaf_hash, execdata.codeseparator_pos,
                            sighash)) {
            *err = SE_SCHNORR_SIG_HASHTYPE;
            return false;
        }
        Bytes msg(sighash, sighash + 32);
        if (!resolve(1, 0, pubkey, sig, msg)) {
            *err = SE_SCHNORR_SIG;
            return false;
        }
        return true;
    }

    bool check_lock_time(i64 lock_time) {
        i64 tx_lock = (i64)tx->locktime;
        if (!((tx_lock < LOCKTIME_THRESHOLD && lock_time < LOCKTIME_THRESHOLD) ||
              (tx_lock >= LOCKTIME_THRESHOLD && lock_time >= LOCKTIME_THRESHOLD)))
            return false;
        if (lock_time > tx_lock) return false;
        if (tx->vin[n_in].sequence == SEQUENCE_FINAL) return false;
        return true;
    }

    bool check_sequence(i64 sequence) {
        u32 tx_sequence = tx->vin[n_in].sequence;
        if ((u32)tx->version < 2) return false;
        if (tx_sequence & SEQ_DISABLE) return false;
        u32 mask = SEQ_TYPE | SEQ_MASK;
        u32 tx_masked = tx_sequence & mask;
        u32 seq_masked = (u32)sequence & mask;
        if (!((tx_masked < SEQ_TYPE && seq_masked < SEQ_TYPE) ||
              (tx_masked >= SEQ_TYPE && seq_masked >= SEQ_TYPE)))
            return false;
        if (seq_masked > tx_masked) return false;
        return true;
    }

    bool verify_taproot_tweak(const Bytes& q, int parity, const Bytes& p,
                              const Bytes& t) {
        return resolve(2, parity, q, p, t);
    }
};

// --------------------------------------------------------------------------
// Encoding checks (interpreter.cpp:107-227 twins; byte-level only).

inline bool is_valid_signature_encoding(const Bytes& sig) {
    if (sig.size() < 9 || sig.size() > 73) return false;
    if (sig[0] != 0x30) return false;
    if (sig[1] != sig.size() - 3) return false;
    size_t lenR = sig[3];
    if (5 + lenR >= sig.size()) return false;
    size_t lenS = sig[5 + lenR];
    if (lenR + lenS + 7 != sig.size()) return false;
    if (sig[2] != 0x02) return false;
    if (lenR == 0) return false;
    if (sig[4] & 0x80) return false;
    if (lenR > 1 && sig[4] == 0x00 && !(sig[5] & 0x80)) return false;
    if (sig[lenR + 4] != 0x02) return false;
    if (lenS == 0) return false;
    if (sig[lenR + 6] & 0x80) return false;
    if (lenS > 1 && sig[lenR + 6] == 0x00 && !(sig[lenR + 7] & 0x80)) return false;
    return true;
}

inline bool is_low_der_signature(const Bytes& sig) {
    // strict-DER already checked by the caller; parse (r, s) laxly and
    // test s <= n/2 (pubkey.cpp:301-308 CheckLowS).
    Sc r, s;
    if (!parse_der_lax(sig.data(), sig.size() - 1, &r, &s)) return false;
    return !sc_is_high(s);
}

inline bool is_compressed_or_uncompressed_pubkey(const Bytes& pk) {
    if (pk.size() < 33) return false;
    if (pk[0] == 0x04) return pk.size() == 65;
    if (pk[0] == 0x02 || pk[0] == 0x03) return pk.size() == 33;
    return false;
}

inline bool is_compressed_pubkey(const Bytes& pk) {
    return pk.size() == 33 && (pk[0] == 0x02 || pk[0] == 0x03);
}

inline i32 check_signature_encoding(const Bytes& sig, u32 flags) {
    if (sig.empty()) return SE_OK;
    if (flags & (F_DERSIG | F_LOW_S | F_STRICTENC)) {
        if (!is_valid_signature_encoding(sig)) return SE_SIG_DER;
    }
    if (flags & F_LOW_S) {
        if (!is_valid_signature_encoding(sig)) return SE_SIG_DER;
        if (!is_low_der_signature(sig)) return SE_SIG_HIGH_S;
    }
    if (flags & F_STRICTENC) {
        int hash_type = sig.back() & ~0x80;
        if (hash_type < 1 || hash_type > 3) return SE_SIG_HASHTYPE;
    }
    return SE_OK;
}

inline i32 check_pubkey_encoding(const Bytes& pk, u32 flags, int sigversion) {
    if ((flags & F_STRICTENC) && !is_compressed_or_uncompressed_pubkey(pk))
        return SE_PUBKEYTYPE;
    if ((flags & F_WITNESS_PUBKEYTYPE) && sigversion == SV_WITNESS_V0 &&
        !is_compressed_pubkey(pk))
        return SE_WITNESS_PUBKEYTYPE;
    return SE_OK;
}

}  // namespace nat
