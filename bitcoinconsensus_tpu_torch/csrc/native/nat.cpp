// Verbatim copy of native/nat.cpp, the JAX package's native host core, built by the port's ops/_build.py.
// C ABI for the native host core. Exports:
//
// - nat_prep_lanes: batch lane preparation for the TPU verify kernel —
//   the native twin of TpuSecpVerifier._prep_lanes + _pack_lanes
//   (crypto/jax_backend.py): structural pubkey parse, lax-DER, high-S
//   normalization, Montgomery-batched s^-1 mod n, BIP340 challenge
//   hashing, GLV lambda split, byte packing. One call per dispatch chunk.
// - nat_verify_{ecdsa,schnorr}, nat_tweak_add_check: full host-exact
//   single verifies (the scalar fallback path).
// - nat_sha256 / nat_sha256d / nat_tagged_hash: hashing utilities.
//
// Layouts must stay bit-identical to the Python packers; the test suite
// asserts equality lane by lane (tests/test_native.py).

#include "block.hpp"
#include "eval.hpp"
#include "secp.hpp"

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <thread>

using namespace nat;

namespace {

constexpr int KIND_ECDSA = 0;
constexpr int KIND_SCHNORR = 1;
constexpr int KIND_TWEAK = 2;

struct Lane {
    // mirrors jax_backend._Lane defaults
    bool valid = false;
    Sc a{};                    // fixed-base scalar
    u64 b1[2] = {0, 0};        // |GLV half 1| little-endian
    u64 b2[2] = {0, 0};
    i32 neg1 = 0, neg2 = 0;
    U256 px{};                 // raw x (defaults to G_X below)
    i32 want_odd = 0;
    U256 t1{};                 // raw target
    i32 has_t2 = 0;
    i32 parity = -1;
};

inline void set_b(Lane& ln, const Sc& b) {
    GlvSplit sp = split_lambda(b);
    if (!sp.ok) {  // cannot happen for k < n; defensive
        ln.valid = false;
        return;
    }
    ln.b1[0] = sp.a1[0];
    ln.b1[1] = sp.a1[1];
    ln.b2[0] = sp.a2[0];
    ln.b2[1] = sp.a2[1];
    ln.neg1 = sp.neg1;
    ln.neg2 = sp.neg2;
}

// Structural half of pubkey parsing (jax_backend._host_parse_pubkey): no
// square root for compressed keys — the y lift happens on device from
// (x, want_odd); the 65-byte form shares parse_uncompressed_pubkey with
// the host-exact verify path.
inline bool host_parse_pubkey(Lane& ln, const u8* pk, i64 len) {
    if (len == 33 && (pk[0] == 2 || pk[0] == 3)) {
        U256 x = u256_from_be(pk + 1);
        if (u256_cmp(x, FIELD_P()) >= 0) return false;
        ln.px = x;
        ln.want_odd = pk[0] == 3 ? 1 : 0;
        return true;
    }
    if (len == 65 && (pk[0] == 4 || pk[0] == 6 || pk[0] == 7)) {
        Fe x, y;
        if (!parse_uncompressed_pubkey(pk, &x, &y)) return false;
        ln.px = x.n;
        ln.want_odd = fe_is_odd(y) ? 1 : 0;
        return true;
    }
    return false;
}

// Shared bodies for the records/spec drain trios and the single/batched
// verify surfaces (one implementation, two wire paths).

void fill_records_meta(const std::vector<Record>& v, i32* kinds, i32* parities,
                       i64* lens) {
    for (size_t i = 0; i < v.size(); i++) {
        const Record& r = v[i];
        kinds[i] = r.kind;
        parities[i] = r.parity;
        lens[3 * i] = (i64)r.p0.size();
        lens[3 * i + 1] = (i64)r.p1.size();
        lens[3 * i + 2] = (i64)r.p2.size();
    }
}

i64 records_total_bytes(const std::vector<Record>& v) {
    i64 total = 0;
    for (const Record& r : v)
        total += (i64)(r.p0.size() + r.p1.size() + r.p2.size());
    return total;
}

void fill_records_data(const std::vector<Record>& v, u8* blob) {
    size_t pos = 0;
    for (const Record& r : v) {
        std::memcpy(blob + pos, r.p0.data(), r.p0.size());
        pos += r.p0.size();
        std::memcpy(blob + pos, r.p1.data(), r.p1.size());
        pos += r.p1.size();
        std::memcpy(blob + pos, r.p2.data(), r.p2.size());
        pos += r.p2.size();
    }
}

// One input through verify_script with a (possibly deferring) checker;
// bounds-checks n_in. Does NOT touch the session's records/unknown state —
// callers own the clear/boundary bookkeeping.
i32 run_verify_input(Session* sess, NTx* tx, i32 n_in, i64 amount,
                     const u8* spk, i64 spk_len, i32 flags, i32 mode,
                     i32* script_err, i32* unknown) {
    if (n_in < 0 || (size_t)n_in >= tx->vin.size()) {
        *script_err = SE_UNKNOWN_ERROR;
        *unknown = 0;
        return 0;
    }
    if (sess) sess->unknown = 0;
    Checker checker;
    checker.tx = tx;
    checker.n_in = (size_t)n_in;
    checker.amount = amount;
    checker.mode = mode;
    checker.sess = sess;
    Bytes spk_b(spk, spk + spk_len);
    EvalResult r = verify_script(tx->vin[(size_t)n_in].script_sig, spk_b,
                                 tx->vin[(size_t)n_in].witness, (u32)flags,
                                 checker);
    *script_err = r.err;
    *unknown = sess ? sess->unknown : 0;
    return r.ok ? 1 : 0;
}

// --- Reference-compatible libbitcoinconsensus ABI -------------------------
// Drop-in twins of the reference's three exported symbols
// (bitcoinconsensus.h:67-75): same signatures, same error enum
// (bitcoinconsensus.h:38-46), same check ordering (flags -> deserialize ->
// index -> size, bitcoinconsensus.cpp:79-102). Consumers that link
// libbitcoinconsensus can link libnat instead; tests/test_drop_in_abi.py
// replays the differential corpus through BOTH .so's via one ctypes path.

constexpr i32 BC_ERR_OK = 0;
constexpr i32 BC_ERR_TX_INDEX = 1;
constexpr i32 BC_ERR_TX_SIZE_MISMATCH = 2;
constexpr i32 BC_ERR_TX_DESERIALIZE = 3;
constexpr i32 BC_ERR_AMOUNT_REQUIRED = 4;
constexpr i32 BC_ERR_INVALID_FLAGS = 5;

// bitcoinconsensus_SCRIPT_FLAGS_VERIFY_ALL (bitcoinconsensus.h:49-61):
// P2SH | DERSIG | NULLDUMMY | CHECKLOCKTIMEVERIFY | CHECKSEQUENCEVERIFY |
// WITNESS. Anything outside is rejected (verify_flags,
// bitcoinconsensus.cpp:74-77).
constexpr u32 BC_FLAGS_VERIFY_ALL =
    (1u << 0) | (1u << 2) | (1u << 4) | (1u << 9) | (1u << 10) | (1u << 11);

inline int bc_set_error(i32* err, i32 code) {
    if (err) *err = code;
    return 0;
}

int bc_verify(const u8* spk, u32 spk_len, i64 amount, const u8* tx_to,
              u32 tx_to_len, u32 n_in, u32 flags, i32* err) {
    if (flags & ~BC_FLAGS_VERIFY_ALL)
        return bc_set_error(err, BC_ERR_INVALID_FLAGS);
    try {
        std::unique_ptr<NTx> tx(tx_parse(tx_to, (size_t)tx_to_len));
        if (n_in >= tx->vin.size()) return bc_set_error(err, BC_ERR_TX_INDEX);
        // Exact re-serialization check (bitcoinconsensus.cpp:91-92):
        // trailing bytes or non-canonical encodings that still parse must
        // report TX_SIZE_MISMATCH.
        if (tx->ser_size != (i64)tx_to_len)
            return bc_set_error(err, BC_ERR_TX_SIZE_MISMATCH);
        // Regardless of the verification result, the tx did not error
        // (bitcoinconsensus.cpp:94-95).
        bc_set_error(err, BC_ERR_OK);
        precompute(*tx, nullptr);
        i32 script_err, unknown;
        return run_verify_input(nullptr, tx.get(), (i32)n_in, amount, spk,
                                (i64)spk_len, (i32)flags, MODE_EXACT,
                                &script_err, &unknown);
    } catch (...) {
        // Same fence as the reference shim (bitcoinconsensus.cpp:99-101).
        return bc_set_error(err, BC_ERR_TX_DESERIALIZE);
    }
}

}  // namespace

extern "C" {

// 4: nat_session_recidx_data grew a capacity argument + i64 return;
//    the nat_block_* / nat_view_* block layer landed.
int nat_version() { return 4; }

// --- Block layer (native/block.hpp) ---------------------------------------

void* nat_block_parse(const u8* data, i64 len) {
    try {
        return block_parse(data, (size_t)len);
    } catch (...) {
        return nullptr;
    }
}

void nat_block_free(void* b) { delete static_cast<NBlock*>(b); }

i32 nat_block_n_tx(void* b) {
    return (i32)static_cast<NBlock*>(b)->vtx.size();
}

// Total non-coinbase inputs (the script-phase lane count).
i32 nat_block_n_inputs(void* b) {
    auto* blk = static_cast<NBlock*>(b);
    i64 n = 0;
    for (const auto& tx : blk->vtx)
        if (!tx_is_coinbase(*tx)) n += (i64)tx->vin.size();
    return (i32)n;
}

// Borrowed pointer into the block (freed with the block, never by
// nat_tx_free).
void* nat_block_tx(void* b, i32 i) {
    auto* blk = static_cast<NBlock*>(b);
    if (i < 0 || (size_t)i >= blk->vtx.size()) return nullptr;
    return blk->vtx[(size_t)i].get();
}

void nat_block_txid(void* b, i32 i, u8* out32) {
    auto* blk = static_cast<NBlock*>(b);
    std::memcpy(out32, blk->txids[(size_t)i].data(), 32);
}

void nat_block_wtxid(void* b, i32 i, u8* out32) {
    auto* blk = static_cast<NBlock*>(b);
    std::memcpy(out32, blk->wtxids[(size_t)i].data(), 32);
}

// Context-free CheckBlock; returns a BlkReason code (0 = ok).
i32 nat_block_check(void* b, i32 do_pow, const u8* pow_limit_be,
                    i32 do_merkle) {
    return check_block(*static_cast<NBlock*>(b), do_pow != 0, pow_limit_be,
                       do_merkle != 0);
}

i32 nat_block_check_witness(void* b) {
    return check_witness_commitment(*static_cast<NBlock*>(b));
}

i32 nat_block_accounting(void* b, void* v, i64 height, i32 flags) {
    return block_accounting(*static_cast<NBlock*>(b),
                            *static_cast<NView*>(v), height, (u32)flags);
}

void nat_block_acct_meta(void* b, i64* fees, i64* sigop_cost, i64* n_inputs,
                         i64* spk_bytes) {
    const BlockAcct& A = static_cast<NBlock*>(b)->acct;
    *fees = A.fees;
    *sigop_cost = A.sigop_cost;
    *n_inputs = (i64)A.tx_index.size();
    *spk_bytes = (i64)A.spk_blob.size();
}

void nat_block_acct_data(void* b, i32* tx_index, i32* n_in, i64* amounts,
                         i64* spk_offs, u8* spk_blob) {
    const BlockAcct& A = static_cast<NBlock*>(b)->acct;
    size_t n = A.tx_index.size();
    if (n) {
        std::memcpy(tx_index, A.tx_index.data(), n * sizeof(i32));
        std::memcpy(n_in, A.n_in.data(), n * sizeof(i32));
        std::memcpy(amounts, A.amounts.data(), n * sizeof(i64));
    }
    std::memcpy(spk_offs, A.spk_offs.data(), (n + 1) * sizeof(i64));
    if (!A.spk_blob.empty())
        std::memcpy(spk_blob, A.spk_blob.data(), A.spk_blob.size());
}

// Per-tx spent-output digests (models/sigcache.py spent_digest stream);
// coinbase rows are zero. out: n_tx * 32 bytes.
void nat_block_spent_digests(void* b, u8* out) {
    const BlockAcct& A = static_cast<NBlock*>(b)->acct;
    for (size_t t = 0; t < A.spent_digests.size(); t++)
        std::memcpy(out + 32 * t, A.spent_digests[t].data(), 32);
}

// Script-execution-cache keys for every non-coinbase input (valid after
// accounting): the models/sigcache.py `_key(_parts(wtxid, n_in, flags,
// spent_digest))` stream — sha256(salt || [len(part) 4LE || part]...)
// with parts (wtxid32, n_in 4LE, flags 4LE, digest32). out: n_inputs*32.
void nat_block_script_keys(void* b, const u8* salt, i64 salt_len, i32 flags,
                           u8* out) {
    auto* blk = static_cast<NBlock*>(b);
    const BlockAcct& A = blk->acct;
    auto part = [](Sha256& h, const u8* p, u32 len) {
        u8 lb[4] = {u8(len), u8(len >> 8), u8(len >> 16), u8(len >> 24)};
        h.write(lb, 4);
        h.write(p, len);
    };
    u8 f4[4] = {u8(flags), u8(flags >> 8), u8(flags >> 16), u8(flags >> 24)};
    // One midstate per (salt); wtxid/digest swap per tx.
    for (size_t j = 0; j < A.tx_index.size(); j++) {
        i32 t = A.tx_index[j];
        Sha256 h;
        h.write(salt, (size_t)salt_len);
        part(h, blk->wtxids[(size_t)t].data(), 32);
        i32 n = A.n_in[j];
        u8 n4[4] = {u8(n), u8(n >> 8), u8(n >> 16), u8(n >> 24)};
        part(h, n4, 4);
        part(h, f4, 4);
        part(h, A.spent_digests[(size_t)t].data(), 32);
        h.finalize(out + 32 * j);
    }
}

void* nat_view_new() { return new NView(); }

void nat_view_free(void* v) { delete static_cast<NView*>(v); }

void* nat_view_clone(void* v) {
    return new NView(*static_cast<NView*>(v));
}

i64 nat_view_len(void* v) {
    return (i64)static_cast<NView*>(v)->map.size();
}

// Batch coin insert: coin i is (txids[32i..32i+32), ns[i]) ->
// (values[i], heights[i], coinbases[i], spk_blob[spk_offs[i]..spk_offs[i+1])).
void nat_view_add_coins(void* v, i32 n, const u8* txids, const i32* ns,
                        const i64* values, const i32* heights,
                        const i32* coinbases, const u8* spk_blob,
                        const i64* spk_offs) {
    auto* view = static_cast<NView*>(v);
    for (i32 i = 0; i < n; i++) {
        NCoin c;
        c.value = values[i];
        c.height = heights[i];
        c.coinbase = coinbases[i] != 0;
        c.spk.assign(spk_blob + spk_offs[i], spk_blob + spk_offs[i + 1]);
        view->map[NView::key(txids + 32 * (size_t)i, (u32)ns[i])] =
            std::move(c);
    }
}

// Point query: returns 1 if present (filling value/height/coinbase/spk_len),
// else 0. The scriptPubKey bytes follow via nat_view_get_spk.
i32 nat_view_get(void* v, const u8* txid, i32 n, i64* value, i32* height,
                 i32* coinbase, i64* spk_len) {
    auto* view = static_cast<NView*>(v);
    auto it = view->map.find(NView::key(txid, (u32)n));
    if (it == view->map.end()) return 0;
    *value = it->second.value;
    *height = it->second.height;
    *coinbase = it->second.coinbase ? 1 : 0;
    *spk_len = (i64)it->second.spk.size();
    return 1;
}

void nat_view_get_spk(void* v, const u8* txid, i32 n, u8* out) {
    auto* view = static_cast<NView*>(v);
    auto it = view->map.find(NView::key(txid, (u32)n));
    if (it == view->map.end()) return;
    std::memcpy(out, it->second.spk.data(), it->second.spk.size());
}

i32 nat_view_spend(void* v, const u8* txid, i32 n) {
    auto* view = static_cast<NView*>(v);
    return view->map.erase(NView::key(txid, (u32)n)) ? 1 : 0;
}

void nat_view_apply_block(void* v, void* b, i64 height) {
    view_apply_block(*static_cast<NView*>(v), *static_cast<NBlock*>(b),
                     height);
}

// The three libbitcoinconsensus exports (bitcoinconsensus.h:67-75).

int bitcoinconsensus_verify_script_with_amount(
    const unsigned char* scriptPubKey, unsigned int scriptPubKeyLen,
    int64_t amount, const unsigned char* txTo, unsigned int txToLen,
    unsigned int nIn, unsigned int flags, i32* err) {
    return bc_verify(scriptPubKey, scriptPubKeyLen, (i64)amount, txTo, txToLen,
                     nIn, flags, err);
}

int bitcoinconsensus_verify_script(const unsigned char* scriptPubKey,
                                   unsigned int scriptPubKeyLen,
                                   const unsigned char* txTo,
                                   unsigned int txToLen, unsigned int nIn,
                                   unsigned int flags, i32* err) {
    // The amount-less entry cannot serve BIP143 sighashes: WITNESS
    // requires an amount (bitcoinconsensus.cpp:115-121).
    if (flags & (1u << 11)) return bc_set_error(err, BC_ERR_AMOUNT_REQUIRED);
    return bc_verify(scriptPubKey, scriptPubKeyLen, 0, txTo, txToLen, nIn,
                     flags, err);
}

unsigned int bitcoinconsensus_version() {
    return 1;  // BITCOINCONSENSUS_API_VER (bitcoinconsensus.h:36)
}

unsigned int nat_murmur3_32(unsigned int seed, const u8* data, i64 len) {
    return murmur3_32(seed, data, (size_t)len);
}

void nat_sha256(const u8* data, i64 len, u8* out32) {
    sha256(data, (size_t)len, out32);
}

void nat_sha256d(const u8* data, i64 len, u8* out32) {
    sha256d(data, (size_t)len, out32);
}

void nat_tagged_hash(const u8* tag, i64 taglen, const u8* data, i64 len,
                     u8* out32) {
    u8 th[32];
    sha256(tag, (size_t)taglen, th);
    Sha256 h;
    h.write(th, 32);
    h.write(th, 32);
    h.write(data, (size_t)len);
    h.finalize(out32);
}

int nat_verify_ecdsa(const u8* pub, i64 publen, const u8* sig, i64 siglen,
                     const u8* msg32) {
    return verify_ecdsa(pub, (size_t)publen, sig, (size_t)siglen, msg32) ? 1 : 0;
}

int nat_verify_schnorr(const u8* pk32, const u8* sig64, const u8* msg32) {
    return verify_schnorr(pk32, sig64, msg32) ? 1 : 0;
}

int nat_tweak_add_check(const u8* tweaked32, i32 parity, const u8* internal32,
                        const u8* tweak32) {
    return tweak_add_check(tweaked32, parity, internal32, tweak32) ? 1 : 0;
}

// One check's parts, independent of where the bytes live (wire blob from
// Python or a session-resident Record) — the shared input shape of the
// lane-prep and digest cores.
struct PartsView {
    int kind;    // 0 ecdsa, 1 schnorr, 2 tweak
    int parity;  // tweak parity bit
    const u8* p0;
    i64 l0;
    const u8* p1;
    i64 l1;
    const u8* p2;
    i64 l2;
};

inline PartsView parts_from_wire(const u8* blob, const i64* offs,
                                 const i32* kinds, i32 i) {
    return PartsView{
        kinds[i] & 0xff,          (kinds[i] >> 8) & 1,
        blob + offs[3 * i],       offs[3 * i + 1] - offs[3 * i],
        blob + offs[3 * i + 1],   offs[3 * i + 2] - offs[3 * i + 1],
        blob + offs[3 * i + 2],   offs[3 * i + 3] - offs[3 * i + 2],
    };
}

// Record/digest part order (ecdsa pubkey|sig|msg, schnorr pk32|sig64|msg,
// tweak q32|internal32|tweak32 — the models/sigcache.py stream order).
inline PartsView parts_from_record(const Record& r) {
    return PartsView{
        r.kind,          r.parity,
        r.p0.data(),     (i64)r.p0.size(),
        r.p1.data(),     (i64)r.p1.size(),
        r.p2.data(),     (i64)r.p2.size(),
    };
}

// Lane-prep part order: the prep core expects tweak checks as
// internal32 | tweak32 | tweaked32 (the prep_pack wire permutation).
inline PartsView parts_from_record_lanes(const Record& r) {
    if (r.kind == KIND_TWEAK)
        return PartsView{
            r.kind,          r.parity,
            r.p1.data(),     (i64)r.p1.size(),
            r.p2.data(),     (i64)r.p2.size(),
            r.p0.data(),     (i64)r.p0.size(),
        };
    return parts_from_record(r);
}

// Lane-prep core: parts -> packed kernel lanes. Parts per kind:
//     ecdsa:   pubkey | sig_der | msg32
//     schnorr: pk32   | sig64   | msg32
//     tweak:   internal32 | tweak32 | tweaked32
// Outputs (caller-allocated, only the first n lanes are written):
//   fields: n*128 bytes — per lane (a | b1 | b2 | px | t1) little-endian
//   want_odd/parity/has_t2/neg1/neg2/valid: n x i32 each
void prep_lanes_impl(const std::vector<PartsView>& parts, u8* fields,
                     i32* want_odd, i32* parity, i32* has_t2, i32* neg1,
                     i32* neg2, i32* valid) {
    // Pass 1: parse everything; collect ECDSA (r, s, m) for the batched
    // inversion (jax_backend._batch_inv_mod_n shape: one Fermat total).
    const i32 n = (i32)parts.size();
    std::vector<Lane> lanes((size_t)n);
    std::vector<i32> ecdsa_idx((size_t)n);
    std::vector<Sc> ecdsa_r((size_t)n);
    std::vector<Sc> ecdsa_s((size_t)n);
    std::vector<Sc> ecdsa_m((size_t)n);
    i32 n_ecdsa = 0;

    for (i32 i = 0; i < n; i++) {
        Lane& ln = lanes[i];
        ln.px = GEN().x.n;  // invalid-lane default matches _Lane (G_X)
        const u8* p0 = parts[i].p0;
        i64 l0 = parts[i].l0;
        const u8* p1 = parts[i].p1;
        i64 l1 = parts[i].l1;
        const u8* p2 = parts[i].p2;
        i64 l2 = parts[i].l2;
        int kind = parts[i].kind;
        if (kind == KIND_ECDSA) {
            if (l2 != 32) continue;
            if (!host_parse_pubkey(ln, p0, l0)) continue;
            Sc r, s;
            if (!parse_der_lax(p1, (size_t)l1, &r, &s)) continue;
            if (sc_is_high(s)) s = sc_neg(s);
            if (sc_is_zero(r) || sc_is_zero(s)) continue;
            ln.t1 = r.n;
            U256 rn;
            u64 carry = u256_add(rn, r.n, ORDER_N());
            ln.has_t2 = (!carry && u256_cmp(rn, FIELD_P()) < 0) ? 1 : 0;
            ln.valid = true;
            ecdsa_idx[n_ecdsa] = i;
            ecdsa_r[n_ecdsa] = r;
            ecdsa_s[n_ecdsa] = s;
            ecdsa_m[n_ecdsa] = sc_from_be(p2);
            n_ecdsa++;
        } else if (kind == KIND_SCHNORR) {
            if (l0 != 32 || l1 != 64 || l2 != 32) continue;
            U256 px = u256_from_be(p0);
            if (u256_cmp(px, FIELD_P()) >= 0) continue;
            U256 r_u = u256_from_be(p1);
            U256 s_u = u256_from_be(p1 + 32);
            if (u256_cmp(r_u, FIELD_P()) >= 0) continue;
            if (u256_cmp(s_u, ORDER_N()) >= 0) continue;
            u8 ch_in[96];
            std::memcpy(ch_in, p1, 32);
            std::memcpy(ch_in + 32, p0, 32);
            std::memcpy(ch_in + 64, p2, 32);
            u8 e_b[32];
            BIP340_CHALLENGE().hash(ch_in, 96, e_b);
            Sc e = sc_from_be(e_b);
            ln.px = px;
            ln.want_odd = 0;
            ln.a.n = s_u;
            set_b(ln, sc_neg(e));  // (n - e) mod n
            ln.t1 = r_u;
            ln.parity = 0;
            ln.valid = true;
        } else if (kind == KIND_TWEAK) {
            if (l0 != 32 || l1 != 32 || l2 != 32) continue;
            U256 px = u256_from_be(p0);
            if (u256_cmp(px, FIELD_P()) >= 0) continue;
            U256 t_u = u256_from_be(p1);
            if (u256_cmp(t_u, ORDER_N()) >= 0) continue;
            ln.px = px;
            ln.want_odd = 0;
            ln.a.n = t_u;
            Sc one;
            one.n = {{1, 0, 0, 0}};
            set_b(ln, one);
            ln.t1 = u256_from_be(p2);  // raw: >= p can never match
            ln.parity = parts[i].parity;
            ln.valid = true;
        }
    }

    // Batched modular inverse of the ECDSA s values (Montgomery trick:
    // one Fermat chain total).
    if (n_ecdsa) {
        std::vector<Sc> prefix((size_t)n_ecdsa);
        Sc acc;
        acc.n = {{1, 0, 0, 0}};
        for (i32 j = 0; j < n_ecdsa; j++) {
            acc = sc_mul(acc, ecdsa_s[j]);
            prefix[j] = acc;
        }
        Sc inv = sc_inv(acc);
        for (i32 j = n_ecdsa - 1; j >= 0; j--) {
            Sc sinv = j ? sc_mul(inv, prefix[j - 1]) : inv;
            inv = sc_mul(inv, ecdsa_s[j]);
            Lane& ln = lanes[ecdsa_idx[j]];
            ln.a = sc_mul(ecdsa_m[j], sinv);      // u1
            set_b(ln, sc_mul(ecdsa_r[j], sinv));  // u2
        }
    }

    // Pack (jax_backend._pack_lanes layout).
    for (i32 i = 0; i < n; i++) {
        const Lane& ln = lanes[i];
        u8* f = fields + (size_t)i * 128;
        u256_to_le(ln.a.n, f);
        for (int j = 0; j < 2; j++) {
            u64 w = ln.b1[j];
            for (int k = 0; k < 8; k++) f[32 + 8 * j + k] = u8(w >> (8 * k));
            w = ln.b2[j];
            for (int k = 0; k < 8; k++) f[48 + 8 * j + k] = u8(w >> (8 * k));
        }
        u256_to_le(ln.px, f + 64);
        u256_to_le(ln.t1, f + 96);
        want_odd[i] = ln.want_odd;
        parity[i] = ln.parity;
        has_t2[i] = ln.has_t2;
        neg1[i] = ln.neg1;
        neg2[i] = ln.neg2;
        valid[i] = ln.valid ? 1 : 0;
    }
}

// Wire-shape entry (Python packs blob/offs/kinds; kinds[i]&0xff is the
// kind, bit 8 the tweak parity).
void nat_prep_lanes(const u8* blob, const i64* offs, const i32* kinds, i32 n,
                    u8* fields, i32* want_odd, i32* parity, i32* has_t2,
                    i32* neg1, i32* neg2, i32* valid) {
    std::vector<PartsView> parts;
    parts.reserve((size_t)n);
    for (i32 i = 0; i < n; i++)
        parts.push_back(parts_from_wire(blob, offs, kinds, i));
    prep_lanes_impl(parts, fields, want_odd, parity, has_t2, neg1, neg2,
                    valid);
}

// ---------------------------------------------------------------------------
// Native interpreter surface: tx handles, deferral sessions, verify_input.
// Twin of core/interpreter.verify_script + models/batch.py
// DeferringSignatureChecker; see native/eval.hpp.

void* nat_session_new() { return new Session(); }

void nat_session_free(void* s) { delete static_cast<Session*>(s); }

void nat_session_add_known(void* s, i32 kind, i32 parity, const u8* p0, i64 l0,
                           const u8* p1, i64 l1, const u8* p2, i64 l2,
                           i32 result) {
    auto* sess = static_cast<Session*>(s);
    Bytes a(p0, p0 + l0), b(p1, p1 + l1), c(p2, p2 + l2);
    sess->known[Session::key(kind, parity, a, b, c)] = result != 0;
}

i32 nat_session_records_count(void* s) {
    return (i32)static_cast<Session*>(s)->records.size();
}

// kinds/parities: n each; lens: 3n (p0, p1, p2 lengths per record).
void nat_session_records_meta(void* s, i32* kinds, i32* parities, i64* lens) {
    fill_records_meta(static_cast<Session*>(s)->records, kinds, parities, lens);
}

void nat_session_records_data(void* s, u8* blob) {
    fill_records_data(static_cast<Session*>(s)->records, blob);
}

i64 nat_session_records_bytes(void* s) {
    return records_total_bytes(static_cast<Session*>(s)->records);
}

// --- Speculative-record drain (Session::spec; same wire shape as the
// records_* trio). spec_seen persists so re-interpretations never re-emit.

i32 nat_session_spec_count(void* s) {
    return (i32)static_cast<Session*>(s)->spec.size();
}

void nat_session_spec_meta(void* s, i32* kinds, i32* parities, i64* lens) {
    fill_records_meta(static_cast<Session*>(s)->spec, kinds, parities, lens);
}

i64 nat_session_spec_bytes(void* s) {
    return records_total_bytes(static_cast<Session*>(s)->spec);
}

void nat_session_spec_data(void* s, u8* blob) {
    auto* sess = static_cast<Session*>(s);
    fill_records_data(sess->spec, blob);
    sess->spec.clear();  // drained; spec_seen persists across rounds
}

// Batched oracle publish: check i's parts are blob[offs[3i]..offs[3i+1]) etc.
// (Record part order: ecdsa pubkey|sig|msg, schnorr pk32|sig64|msg,
// tweak q32|internal32|tweak32); kinds[i]&0xff is the kind, bit 8 the
// tweak parity; results[i] the verdict.
void nat_session_add_known_batch(void* s, i32 n, const i32* kinds,
                                 const u8* blob, const i64* offs,
                                 const i32* results) {
    auto* sess = static_cast<Session*>(s);
    for (i32 i = 0; i < n; i++) {
        const u8* p0 = blob + offs[3 * i];
        const u8* p1 = blob + offs[3 * i + 1];
        const u8* p2 = blob + offs[3 * i + 2];
        Bytes a(p0, p1), b(p1, p2), c(p2, blob + offs[3 * i + 3]);
        sess->known[Session::key(kinds[i] & 0xff, (kinds[i] >> 8) & 1, a, b,
                                 c)] = results[i] != 0;
    }
}

// Batched salted cache-key digests, byte-identical to the Python
// models/sigcache.py `_key(_parts(kind, data))` stream:
//   sha256(salt || [len(part) as 4-byte LE || part]...)
// with parts = [kind-name, data...] and the tweak parity serialized as an
// 8-byte signed little-endian int between q32 and internal32.
// Digest core shared by the wire and session-resident entries.
void digest_one(const u8* salt, i64 salt_len, const PartsView& pv, u8* out32) {
    static const char* NAMES[3] = {"ecdsa", "schnorr", "tweak"};
    Sha256 h;
    h.write(salt, (size_t)salt_len);
    if (pv.kind > KIND_TWEAK) {
        // An unsynchronized kind table must fail loudly, not read OOB.
        std::fprintf(stderr, "digest_one: bad kind %d\n", pv.kind);
        std::abort();
    }
    auto part = [&h](const u8* p, size_t len) {
        u8 lb[4] = {u8(len), u8(len >> 8), u8(len >> 16), u8(len >> 24)};
        h.write(lb, 4);
        h.write(p, len);
    };
    const char* name = NAMES[pv.kind];
    part(reinterpret_cast<const u8*>(name), std::strlen(name));
    part(pv.p0, (size_t)pv.l0);
    if (pv.kind == KIND_TWEAK) {
        u8 pb[8] = {u8(pv.parity & 1), 0, 0, 0, 0, 0, 0, 0};
        part(pb, 8);
    }
    part(pv.p1, (size_t)pv.l1);
    part(pv.p2, (size_t)pv.l2);
    h.finalize(out32);
}

void nat_digest_checks(const u8* salt, i64 salt_len, i32 n, const i32* kinds,
                       const u8* blob, const i64* offs, u8* out) {
    for (i32 i = 0; i < n; i++)
        digest_one(salt, salt_len, parts_from_wire(blob, offs, kinds, i),
                   out + 32 * (size_t)i);
}

// Generic batched salted digests over variable part lists (the script-
// execution-cache keys): item i hashes parts part_bounds[i]..part_bounds[i+1)
// with the models/sigcache.py `_key` stream layout
// (sha256(salt || [len(part) as 4-byte LE || part]...)); part j's bytes are
// blob[part_offs[j]..part_offs[j+1]).
void nat_digest_streams(const u8* salt, i64 salt_len, i32 n,
                        const i64* part_bounds, const i64* part_offs,
                        const u8* blob, u8* out) {
    for (i32 i = 0; i < n; i++) {
        Sha256 h;
        h.write(salt, (size_t)salt_len);
        for (i64 j = part_bounds[i]; j < part_bounds[i + 1]; j++) {
            size_t len = (size_t)(part_offs[j + 1] - part_offs[j]);
            u8 lb[4] = {u8(len), u8(len >> 8), u8(len >> 16), u8(len >> 24)};
            h.write(lb, 4);
            h.write(blob + part_offs[j], len);
        }
        h.finalize(out + 32 * (size_t)i);
    }
}

void* nat_tx_parse(const u8* data, i64 len) {
    try {
        return tx_parse(data, (size_t)len);
    } catch (...) {  // SerErr, bad_alloc, ... — never cross the C ABI
        return nullptr;
    }
}

void nat_tx_wtxid(void* txp, u8* out32) {
    auto* tx = static_cast<NTx*>(txp);
    Bytes b = tx->serialize(true);
    sha256d(b.data(), b.size(), out32);
}

void nat_tx_free(void* tx) { delete static_cast<NTx*>(tx); }

// Serialization export (fuzz harness + consumers needing the canonical
// bytes): two-call pattern — size, then fill.
i64 nat_tx_serialize_size(void* txp, i32 witness) {
    return (i64)static_cast<NTx*>(txp)->serialize(witness != 0).size();
}

void nat_tx_serialize(void* txp, i32 witness, u8* out) {
    Bytes b = static_cast<NTx*>(txp)->serialize(witness != 0);
    std::memcpy(out, b.data(), b.size());
}

i64 nat_tx_ser_size(void* tx) { return static_cast<NTx*>(tx)->ser_size; }

i32 nat_tx_n_inputs(void* tx) {
    return (i32)static_cast<NTx*>(tx)->vin.size();
}

// Precompute the tx-wide hash aggregates; spent outputs (one per input)
// unlock BIP341. spk_offs has n+1 entries into spk_blob.
void nat_tx_set_spent_outputs(void* txp, const i64* amounts, const u8* spk_blob,
                              const i64* spk_offs, i32 n) {
    auto* tx = static_cast<NTx*>(txp);
    std::vector<NTxOut> spent((size_t)n);
    for (i32 i = 0; i < n; i++) {
        spent[i].value = amounts[i];
        spent[i].spk.assign(spk_blob + spk_offs[i], spk_blob + spk_offs[i + 1]);
    }
    precompute(*tx, &spent);
}

void nat_tx_precompute(void* txp) {
    precompute(*static_cast<NTx*>(txp), nullptr);
}

// Verify one input. mode 0 = deferring (records + oracle via sess),
// mode 1 = exact (native curve math; sess may be NULL).
// Returns 1 ok / 0 script-failed; *script_err gets the ScriptError code,
// *unknown the count of oracle misses (deferring mode).
i32 nat_verify_input(void* s, void* txp, i32 n_in, i64 amount, const u8* spk,
                     i64 spk_len, i32 flags, i32 mode, i32* script_err,
                     i32* unknown) {
    auto* sess = static_cast<Session*>(s);
    if (sess) {
        // Symmetric with nat_verify_inputs_idx setting it true: a session
        // that served the index protocol must not keep routing the legacy
        // records path's oracle misses into uniq/rec_idx (the records
        // drain would return 0 entries while unk > 0 and the driver would
        // publish optimistic verdicts with the misses unresolved).
        sess->index_mode = false;
        sess->records.clear();
    }
    return run_verify_input(sess, static_cast<NTx*>(txp), n_in, amount, spk,
                            spk_len, flags, mode, script_err, unknown);
}

// Batched verify: n inputs in one call (the per-call ctypes cost of the
// single-input surface dominates a 3k-input block; this removes it).
// txs[i]/n_ins[i]/amounts[i]/flags[i] per input; input i's scriptPubKey is
// spk_blob[spk_offs[i]..spk_offs[i+1]). Outputs per input: ok/err/unk, and
// rec_bounds (n+1 entries) delimiting its slice of the session's records
// (drained afterwards via the records_* trio). Speculative records
// accumulate session-wide; drain via the spec_* trio.
void nat_verify_inputs(void* s, void** txs, const i32* n_ins,
                       const i64* amounts, const u8* spk_blob,
                       const i64* spk_offs, const i32* flags, i32 mode, i32 n,
                       i32* ok, i32* err, i32* unk, i64* rec_bounds) {
    auto* sess = static_cast<Session*>(s);
    if (sess) {
        sess->index_mode = false;  // see nat_verify_input's comment
        sess->records.clear();
    }
    rec_bounds[0] = 0;
    for (i32 i = 0; i < n; i++) {
        ok[i] = run_verify_input(sess, static_cast<NTx*>(txs[i]), n_ins[i],
                                 amounts[i], spk_blob + spk_offs[i],
                                 spk_offs[i + 1] - spk_offs[i], flags[i], mode,
                                 &err[i], &unk[i]);
        rec_bounds[i + 1] = sess ? (i64)sess->records.size() : 0;
    }
}

// ---------------------------------------------------------------------------
// Index-mode batch surface: the session keeps ONE deduped check list
// (`uniq`) and every consumer — lane prep for the device kernel, salted
// cache digests, verdict publication, exact host fallback — reads it in
// place. Python sees only int32 indices; no check bytes ever cross the
// bridge twice. This is the TPU-era CCheckQueue fan-out
// (checkqueue.h:29-163): `n_threads` shards the per-input interpretation
// across worker threads that share the session's oracle read-only and
// merge their discovered checks serially (order-preserving, so lane
// order is deterministic regardless of thread count).

// Interpret inputs [lo, hi) against `sess` (which may be a worker
// scratch whose `oracle` points at the shared session). Per-input
// rec_idx bounds are recorded into local_bounds[lo..hi].
static void run_idx_range(Session* sess, void** txs, const i32* n_ins,
                          const i64* amounts, const u8* spk_blob,
                          const i64* spk_offs, const i32* flags, i32 lo,
                          i32 hi, i32* ok, i32* err, i32* unk,
                          i64* local_bounds) {
    for (i32 i = lo; i < hi; i++) {
        ok[i] = run_verify_input(sess, static_cast<NTx*>(txs[i]), n_ins[i],
                                 amounts[i], spk_blob + spk_offs[i],
                                 spk_offs[i + 1] - spk_offs[i], flags[i],
                                 MODE_DEFER, &err[i], &unk[i]);
        local_bounds[i + 1] = (i64)sess->rec_idx.size();
    }
}

void nat_verify_inputs_idx(void* s, void** txs, const i32* n_ins,
                           const i64* amounts, const u8* spk_blob,
                           const i64* spk_offs, const i32* flags, i32 n,
                           i32 n_threads, i32* ok, i32* err, i32* unk,
                           i64* rec_bounds) {
    auto* sess = static_cast<Session*>(s);
    sess->index_mode = true;
    sess->rec_idx.clear();
    rec_bounds[0] = 0;
    if (n_threads < 2 || n < 2 * n_threads) {
        // rec_idx was just cleared, so per-input bounds are global bounds.
        run_idx_range(sess, txs, n_ins, amounts, spk_blob, spk_offs, flags, 0,
                      n, ok, err, unk, rec_bounds);
        return;
    }
    i32 T = n_threads;
    std::vector<Session> scratch((size_t)T);
    std::vector<std::vector<i64>> bounds((size_t)T);
    std::vector<std::thread> workers;
    workers.reserve((size_t)T);
    for (i32 t = 0; t < T; t++) {
        scratch[t].index_mode = true;
        scratch[t].oracle = sess;
        bounds[t].assign((size_t)n + 1, 0);
        i32 lo = (i32)((i64)n * t / T);
        i32 hi = (i32)((i64)n * (t + 1) / T);
        workers.emplace_back([&, t, lo, hi] {
            // The scratch session's rec_idx is empty at entry, so the
            // worker's bounds slots [lo+1, hi] are relative to 0.
            run_idx_range(&scratch[t], txs, n_ins, amounts, spk_blob,
                          spk_offs, flags, lo, hi, ok, err, unk,
                          bounds[t].data());
        });
    }
    for (auto& w : workers) w.join();
    // Serial merge in shard order: dedup each scratch's uniq into the
    // shared session, remap its rec_idx entries, and lay down global
    // rec_bounds — identical discovery order to a single-threaded run
    // over the same shard sequence.
    for (i32 t = 0; t < T; t++) {
        Session& sc = scratch[t];
        std::vector<i32> remap(sc.uniq.size());
        for (size_t j = 0; j < sc.uniq.size(); j++) {
            auto ins = sess->uniq_seen.try_emplace(std::move(sc.uniq_keys[j]),
                                                   (i32)sess->uniq.size());
            if (ins.second) {
                sess->uniq.push_back(std::move(sc.uniq[j]));
                sess->uniq_keys.push_back(ins.first->first);
            }
            remap[j] = ins.first->second;
        }
        i32 lo = (i32)((i64)n * t / T);
        i32 hi = (i32)((i64)n * (t + 1) / T);
        for (i32 i = lo; i < hi; i++) {
            for (i64 j = bounds[t][(size_t)i]; j < bounds[t][(size_t)i + 1];
                 j++)
                sess->rec_idx.push_back(remap[(size_t)sc.rec_idx[(size_t)j]]);
            rec_bounds[i + 1] = (i64)sess->rec_idx.size();
        }
    }
}

i32 nat_session_uniq_count(void* s) {
    return (i32)static_cast<Session*>(s)->uniq.size();
}

// A stale or negative uniq index from the driver is an OOB read / heap
// corruption; fail loudly instead (same pattern as digest_one's kind
// guard).
inline const Record& uniq_at(Session* sess, i32 idx) {
    if (idx < 0 || (size_t)idx >= sess->uniq.size()) {
        std::fprintf(stderr, "uniq_at: index %d out of range (uniq size %zu)\n",
                     idx, sess->uniq.size());
        std::abort();
    }
    return sess->uniq[(size_t)idx];
}

// `capacity` is the caller's buffer size (the rec_idx length observed at
// verify time); ctypes releases the GIL during calls, so copying
// rec_idx.size() entries unchecked would overflow the buffer if another
// thread grew the session in between. Returns the count actually copied.
i64 nat_session_recidx_data(void* s, i32* out, i64 capacity) {
    auto* sess = static_cast<Session*>(s);
    i64 n = (i64)sess->rec_idx.size();
    if (capacity < n) n = capacity;
    if (n > 0) std::memcpy(out, sess->rec_idx.data(), (size_t)n * sizeof(i32));
    return n;
}

// Kernel lanes for uniq[idxs[0..nidx)] — session-resident prep, no wire
// blob. Output layout identical to nat_prep_lanes.
void nat_session_uniq_lanes(void* s, const i32* idxs, i32 nidx, u8* fields,
                            i32* want_odd, i32* parity, i32* has_t2,
                            i32* neg1, i32* neg2, i32* valid) {
    auto* sess = static_cast<Session*>(s);
    std::vector<PartsView> parts;
    parts.reserve((size_t)nidx);
    for (i32 j = 0; j < nidx; j++)
        parts.push_back(parts_from_record_lanes(uniq_at(sess, idxs[j])));
    prep_lanes_impl(parts, fields, want_odd, parity, has_t2, neg1, neg2,
                    valid);
}

// Salted cache-key digests for uniq[idxs[0..nidx)] (models/sigcache.py
// key stream — same bytes nat_digest_checks produces for the wire shape).
void nat_session_uniq_digests(void* s, const u8* salt, i64 salt_len,
                              const i32* idxs, i32 nidx, u8* out) {
    auto* sess = static_cast<Session*>(s);
    for (i32 j = 0; j < nidx; j++)
        digest_one(salt, salt_len, parts_from_record(uniq_at(sess, idxs[j])),
                   out + 32 * (size_t)j);
}

// Publish device/cache verdicts for uniq[idxs[0..nidx)] into the oracle.
void nat_session_publish_uniq(void* s, const i32* idxs, i32 nidx,
                              const i32* results) {
    auto* sess = static_cast<Session*>(s);
    for (i32 j = 0; j < nidx; j++) {
        uniq_at(sess, idxs[j]);  // bounds guard (uniq_keys is parallel)
        sess->known[sess->uniq_keys[(size_t)idxs[j]]] = results[j] != 0;
    }
}

// Exact host verdict for one uniq entry (the exceptional-lane fixup path:
// crafted scalar collisions the fast device adds defer — never honest
// traffic).
i32 nat_session_uniq_host_verify(void* s, i32 idx) {
    auto* sess = static_cast<Session*>(s);
    const Record& r = uniq_at(sess, idx);
    if (r.kind == KIND_ECDSA)
        return verify_ecdsa(r.p0.data(), r.p0.size(), r.p1.data(),
                            r.p1.size(), r.p2.data())
                   ? 1
                   : 0;
    if (r.kind == KIND_SCHNORR)
        return verify_schnorr(r.p0.data(), r.p1.data(), r.p2.data()) ? 1 : 0;
    // tweak record order: q32 | internal32 | tweak32
    return tweak_add_check(r.p0.data(), r.parity, r.p1.data(), r.p2.data())
               ? 1
               : 0;
}

}  // extern "C"
