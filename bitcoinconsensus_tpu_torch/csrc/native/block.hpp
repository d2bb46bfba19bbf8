// Verbatim copy of native/block.hpp, the JAX package's native host core, built by the port's ops/_build.py.
// Native block layer: block codec, merkle (CVE-2012-2459), PoW, the
// context-free CheckBlock rules, witness commitment, sigop costing, a
// UTXO view and the ConnectBlock accounting pass.
//
// Twin of bitcoinconsensus_tpu/core/block.py + core/tx_check.py +
// models/validate.py (which mirror the reference's validation.cpp:3402-3474
// CheckBlock, consensus/merkle.cpp:45-84, pow.cpp:74-90,
// consensus/tx_verify.cpp:125-218 and validation.cpp:1946-2228
// ConnectBlock). The Python layer stays the executable spec; byte/verdict
// equality is asserted by tests/test_native_block.py. Reject reasons are
// integer codes here; bitcoinconsensus_tpu/native_bridge.py maps them to
// the reference's reason strings.
#pragma once

#include "interp.hpp"

#include <array>
#include <memory>
#include <unordered_map>
#include <unordered_set>

namespace nat {

constexpr i64 BLK_MAX_WEIGHT = 4'000'000;        // consensus.h:14
constexpr i64 BLK_WITNESS_SCALE = 4;             // consensus.h:21
constexpr i64 BLK_MAX_SIGOPS_COST = 80'000;      // consensus.h:17
constexpr i64 BLK_MAX_MONEY = 21'000'000LL * 100'000'000LL;
constexpr int BLK_COINBASE_MATURITY = 100;       // consensus.h:19
constexpr i64 BLK_HALVING_INTERVAL = 210'000;    // chainparams.cpp mainnet
constexpr int MAX_PUBKEYS_PER_MULTISIG_N = 20;   // script.h:33
constexpr size_t MIN_WITNESS_COMMITMENT_N = 38;  // validation.h:19

// Reject reasons as stable integer codes; the bridge's REASONS table maps
// them to the exact reference strings (order is part of the ABI).
enum BlkReason : i32 {
    BR_OK = 0,
    BR_HIGH_HASH,
    BR_BAD_MERKLE,
    BR_DUPLICATE,
    BR_BAD_LENGTH,
    BR_CB_MISSING,
    BR_CB_MULTIPLE,
    BR_VIN_EMPTY,
    BR_VOUT_EMPTY,
    BR_OVERSIZE,
    BR_VOUT_NEGATIVE,
    BR_VOUT_TOOLARGE,
    BR_TXOUTTOTAL_TOOLARGE,
    BR_INPUTS_DUPLICATE,
    BR_CB_LENGTH,
    BR_PREVOUT_NULL,
    BR_BLK_SIGOPS,
    BR_WITNESS_NONCE_SIZE,
    BR_WITNESS_MERKLE_MATCH,
    BR_UNEXPECTED_WITNESS,
    BR_BIP30,
    BR_INPUTS_MISSINGORSPENT,
    BR_PREMATURE_COINBASE,
    BR_INPUTVALUES_OUTOFRANGE,
    BR_IN_BELOWOUT,
    BR_FEE_OUTOFRANGE,
    BR_CB_AMOUNT,
    BR_DESERIALIZE,
};

using Hash32 = std::array<u8, 32>;

inline bool tx_is_coinbase(const NTx& tx) {
    if (tx.vin.size() != 1) return false;
    const NTxIn& in = tx.vin[0];
    if (in.prevout_n != 0xFFFFFFFFu) return false;
    for (int i = 0; i < 32; i++)
        if (in.prevout_hash[i]) return false;
    return true;
}

// ConnectBlock accounting result (filled by block_accounting below): one
// entry per non-coinbase input, in block order.
struct BlockAcct {
    bool ready = false;
    i64 fees = 0;
    i64 sigop_cost = 0;
    std::vector<i32> tx_index;   // which vtx
    std::vector<i32> n_in;       // which input of that tx
    std::vector<i64> amounts;    // spent-output value per input
    std::vector<i64> spk_offs;   // n_inputs+1 offsets into spk_blob
    Bytes spk_blob;              // spent-output scriptPubKeys
    std::vector<Hash32> spent_digests;  // per tx (coinbase rows zero)
};

struct NBlock {
    i32 version;
    u8 prev_hash[32];
    u8 merkle[32];
    u32 time_, bits, nonce;
    u8 header_hash[32];  // sha256d over the 80 header bytes, wire order
    std::vector<std::unique_ptr<NTx>> vtx;
    std::vector<Hash32> txids;   // sha256d(serialize(false)), wire order
    std::vector<Hash32> wtxids;  // sha256d(serialize(true))
    std::vector<i64> nowit_size;  // per-tx no-witness serialized size
    i64 ser_size = 0;
    BlockAcct acct;
};

// Block wire parse (primitives/block.h:75-90 / core/block.py
// Block.deserialize): 80-byte header + compact count + txs; trailing
// bytes reject. Throws SerErr.
inline NBlock* block_parse(const u8* data, size_t len) {
    Reader r(data, len);
    auto blk = std::make_unique<NBlock>();
    const u8* hdr = r.read(80);
    sha256d(hdr, 80, blk->header_hash);
    {
        Reader hr(hdr, 80);
        blk->version = hr.read_i32();
        std::memcpy(blk->prev_hash, hr.read(32), 32);
        std::memcpy(blk->merkle, hr.read(32), 32);
        blk->time_ = hr.read_u32();
        blk->bits = hr.read_u32();
        blk->nonce = hr.read_u32();
    }
    u64 n = r.read_compact_size();
    for (u64 i = 0; i < n; i++)
        blk->vtx.emplace_back(tx_parse_from(r));
    if (r.pos != r.len) throw SerErr("trailing data after block");
    blk->ser_size = (i64)len;
    blk->txids.resize(blk->vtx.size());
    blk->wtxids.resize(blk->vtx.size());
    blk->nowit_size.resize(blk->vtx.size());
    for (size_t i = 0; i < blk->vtx.size(); i++) {
        Bytes nw = blk->vtx[i]->serialize(false);
        blk->nowit_size[i] = (i64)nw.size();
        sha256d(nw.data(), nw.size(), blk->txids[i].data());
        if (blk->vtx[i]->has_witness()) {
            Bytes w = blk->vtx[i]->serialize(true);
            sha256d(w.data(), w.size(), blk->wtxids[i].data());
        } else {
            blk->wtxids[i] = blk->txids[i];
        }
    }
    return blk.release();
}

// Merkle root with mutation detection (consensus/merkle.cpp:45-64):
// sibling equality is checked BEFORE duplicating the odd tail, so the
// synthetic last pair never counts as mutation.
inline void merkle_root(std::vector<Hash32> level, u8 out[32], bool* mutated) {
    *mutated = false;
    if (level.empty()) {
        std::memset(out, 0, 32);
        return;
    }
    while (level.size() > 1) {
        for (size_t pos = 0; pos + 1 < level.size(); pos += 2)
            if (level[pos] == level[pos + 1]) *mutated = true;
        if (level.size() & 1) level.push_back(level.back());
        std::vector<Hash32> next(level.size() / 2);
        for (size_t i = 0; i < level.size(); i += 2) {
            u8 buf[64];
            std::memcpy(buf, level[i].data(), 32);
            std::memcpy(buf + 32, level[i + 1].data(), 32);
            sha256d(buf, 64, next[i / 2].data());
        }
        level = std::move(next);
    }
    std::memcpy(out, level[0].data(), 32);
}

// Compact bits -> 32-byte big-endian target (arith_uint256 SetCompact).
inline void bits_to_target_be(u32 bits, u8 out_be[32], bool* negative,
                              bool* overflow) {
    std::memset(out_be, 0, 32);
    u32 size = bits >> 24;
    u32 word = bits & 0x007FFFFF;
    *negative = word != 0 && (bits & 0x00800000) != 0;
    *overflow = word != 0 && (size > 34 || (word > 0xFF && size > 33) ||
                              (word > 0xFFFF && size > 32));
    if (*overflow) return;
    if (size <= 3) {
        word >>= 8 * (3 - size);
        out_be[29] = u8(word >> 16);
        out_be[30] = u8(word >> 8);
        out_be[31] = u8(word);
    } else {
        // value = word * 256^(size-3): word's 3 bytes end (8*(size-3))
        // bytes above the bottom.
        for (int i = 0; i < 3; i++) {
            int pos = 31 - (int)(size - 3) - i;  // i=0 -> lowest word byte
            if (pos >= 0 && pos < 32) out_be[pos] = u8(word >> (8 * i));
        }
    }
}

inline int cmp_be(const u8 a[32], const u8 b[32]) {
    return std::memcmp(a, b, 32);
}

inline bool be_is_zero(const u8 a[32]) {
    for (int i = 0; i < 32; i++)
        if (a[i]) return false;
    return true;
}

// CheckProofOfWork (pow.cpp:74-90); header hash arrives wire (LE) order,
// pow_limit as 32 big-endian bytes.
inline bool check_pow(const u8 header_hash[32], u32 bits,
                      const u8 pow_limit_be[32]) {
    u8 target[32];
    bool neg, over;
    bits_to_target_be(bits, target, &neg, &over);
    if (neg || be_is_zero(target) || over) return false;
    if (cmp_be(target, pow_limit_be) > 0) return false;
    u8 hash_be[32];
    for (int i = 0; i < 32; i++) hash_be[i] = header_hash[31 - i];
    return cmp_be(hash_be, target) <= 0;
}

// Legacy sigop counting (script.cpp:153-177 / core/script.py
// get_sig_op_count).
inline i64 sig_op_count(const Bytes& script, bool accurate) {
    i64 n = 0;
    int last_opcode = 0xFF;  // OP_INVALIDOPCODE
    Span sp = span_of(script);
    size_t pos = 0;
    while (pos < sp.size()) {
        int opcode;
        const u8* d;
        size_t dl;
        if (!decode_op(sp, pos, opcode, &d, &dl)) break;
        if (opcode == OP_CHECKSIG || opcode == OP_CHECKSIGVERIFY) {
            n += 1;
        } else if (opcode == OP_CHECKMULTISIG ||
                   opcode == OP_CHECKMULTISIGVERIFY) {
            if (accurate && last_opcode >= OP_1 && last_opcode <= OP_16)
                n += last_opcode - OP_1 + 1;
            else
                n += MAX_PUBKEYS_PER_MULTISIG_N;
        }
        last_opcode = opcode;
    }
    return n;
}

// WitnessSigOps (interpreter.cpp:2058-2072).
inline i64 witness_sig_ops(int version, const Bytes& program,
                           const std::vector<Bytes>& witness) {
    if (version == 0) {
        if (program.size() == 20) return 1;
        if (program.size() == 32 && !witness.empty())
            return sig_op_count(witness.back(), true);
    }
    return 0;
}

// Last push of a push-only scriptSig (the P2SH redeem script).
inline Bytes last_push(const Bytes& script) {
    Bytes data;
    Span sp = span_of(script);
    size_t pos = 0;
    while (pos < sp.size()) {
        int opcode;
        const u8* d;
        size_t dl;
        if (!decode_op(sp, pos, opcode, &d, &dl)) break;
        data.assign(d ? d : (const u8*)"", d ? d + dl : (const u8*)"");
    }
    return data;
}

// CountWitnessSigOps (interpreter.cpp:2074-2103).
inline i64 count_witness_sigops(const Bytes& script_sig, const Bytes& spk,
                                const std::vector<Bytes>& witness, u32 flags) {
    if (!(flags & F_WITNESS)) return 0;
    int version;
    Bytes program;
    if (is_witness_program(spk, &version, &program))
        return witness_sig_ops(version, program, witness);
    if (is_p2sh(spk) && is_push_only(script_sig)) {
        Bytes redeem = last_push(script_sig);
        if (is_witness_program(redeem, &version, &program))
            return witness_sig_ops(version, program, witness);
    }
    return 0;
}

// GetTransactionSigOpCost (consensus/tx_verify.cpp:125-147). `spent` must
// be one output per input for non-coinbase txs.
inline i64 tx_sigop_cost(const NTx& tx, const std::vector<const NTxOut*>& spent,
                         u32 flags) {
    i64 cost = 0;
    for (const auto& in : tx.vin) cost += sig_op_count(in.script_sig, false);
    for (const auto& out : tx.vout) cost += sig_op_count(out.spk, false);
    cost *= BLK_WITNESS_SCALE;
    if (tx_is_coinbase(tx)) return cost;
    if (flags & F_P2SH) {
        i64 p2sh = 0;
        for (size_t i = 0; i < tx.vin.size(); i++) {
            if (is_p2sh(spent[i]->spk) && is_push_only(tx.vin[i].script_sig))
                p2sh += sig_op_count(last_push(tx.vin[i].script_sig), true);
        }
        cost += p2sh * BLK_WITNESS_SCALE;
    }
    for (size_t i = 0; i < tx.vin.size(); i++)
        cost += count_witness_sigops(tx.vin[i].script_sig, spent[i]->spk,
                                     tx.vin[i].witness, flags);
    return cost;
}

// CheckTransaction (consensus/tx_verify.cpp:157-196 / core/tx_check.py).
inline i32 check_transaction(const NTx& tx, i64 nowit_size) {
    if (tx.vin.empty()) return BR_VIN_EMPTY;
    if (tx.vout.empty()) return BR_VOUT_EMPTY;
    if (nowit_size * BLK_WITNESS_SCALE > BLK_MAX_WEIGHT) return BR_OVERSIZE;
    i64 value_out = 0;
    for (const auto& out : tx.vout) {
        if (out.value < 0) return BR_VOUT_NEGATIVE;
        if (out.value > BLK_MAX_MONEY) return BR_VOUT_TOOLARGE;
        value_out += out.value;
        if (value_out < 0 || value_out > BLK_MAX_MONEY)
            return BR_TXOUTTOTAL_TOOLARGE;
    }
    std::unordered_set<std::string> seen;
    for (const auto& in : tx.vin) {
        std::string key(reinterpret_cast<const char*>(in.prevout_hash), 32);
        key.append(reinterpret_cast<const char*>(&in.prevout_n), 4);
        if (!seen.insert(std::move(key)).second) return BR_INPUTS_DUPLICATE;
    }
    if (tx_is_coinbase(tx)) {
        size_t n = tx.vin[0].script_sig.size();
        if (n < 2 || n > 100) return BR_CB_LENGTH;
    } else {
        for (const auto& in : tx.vin) {
            bool null_hash = true;
            for (int i = 0; i < 32; i++)
                if (in.prevout_hash[i]) null_hash = false;
            if (null_hash && in.prevout_n == 0xFFFFFFFFu)
                return BR_PREVOUT_NULL;
        }
    }
    return BR_OK;
}

// Witness-commitment rules (validation.cpp:3385-3428 / core/block.py
// check_witness_commitment).
inline i32 check_witness_commitment(const NBlock& blk) {
    int commitpos = -1;
    if (!blk.vtx.empty()) {
        const NTx& cb = *blk.vtx[0];
        for (size_t o = 0; o < cb.vout.size(); o++) {
            const Bytes& spk = cb.vout[o].spk;
            if (spk.size() >= MIN_WITNESS_COMMITMENT_N && spk[0] == OP_RETURN &&
                spk[1] == 0x24 && spk[2] == 0xAA && spk[3] == 0x21 &&
                spk[4] == 0xA9 && spk[5] == 0xED)
                commitpos = (int)o;
        }
    }
    if (commitpos != -1) {
        const NTx& cb = *blk.vtx[0];
        if (cb.vin.empty()) return BR_WITNESS_NONCE_SIZE;
        const auto& witness = cb.vin[0].witness;
        if (witness.size() != 1 || witness[0].size() != 32)
            return BR_WITNESS_NONCE_SIZE;
        // Witness merkle root: coinbase wtxid pinned to zero
        // (consensus/merkle.cpp:75-84).
        std::vector<Hash32> leaves(blk.vtx.size());
        leaves[0].fill(0);
        for (size_t i = 1; i < blk.vtx.size(); i++) leaves[i] = blk.wtxids[i];
        u8 root[32];
        bool mut_;
        merkle_root(std::move(leaves), root, &mut_);
        u8 buf[64], expect[32];
        std::memcpy(buf, root, 32);
        std::memcpy(buf + 32, witness[0].data(), 32);
        sha256d(buf, 64, expect);
        if (std::memcmp(expect, cb.vout[commitpos].spk.data() + 6, 32) != 0)
            return BR_WITNESS_MERKLE_MATCH;
        return BR_OK;
    }
    for (const auto& tx : blk.vtx)
        if (tx->has_witness()) return BR_UNEXPECTED_WITNESS;
    return BR_OK;
}

// Context-free CheckBlock (validation.cpp:3402-3474 / core/block.py
// check_block). `pow_limit_be`: 32 big-endian bytes.
inline i32 check_block(const NBlock& blk, bool do_pow,
                       const u8 pow_limit_be[32], bool do_merkle) {
    if (do_pow && !check_pow(blk.header_hash, blk.bits, pow_limit_be))
        return BR_HIGH_HASH;
    if (do_merkle) {
        u8 root[32];
        bool mutated;
        merkle_root(blk.txids, root, &mutated);
        if (std::memcmp(blk.merkle, root, 32) != 0) return BR_BAD_MERKLE;
        if (mutated) return BR_DUPLICATE;
    }
    i64 nowit_total = 80;
    {
        Bytes cs;
        put_compact_size(cs, blk.vtx.size());
        nowit_total += (i64)cs.size();
    }
    for (i64 s : blk.nowit_size) nowit_total += s;
    if (blk.vtx.empty() ||
        (i64)blk.vtx.size() * BLK_WITNESS_SCALE > BLK_MAX_WEIGHT ||
        nowit_total * BLK_WITNESS_SCALE > BLK_MAX_WEIGHT)
        return BR_BAD_LENGTH;
    if (!tx_is_coinbase(*blk.vtx[0])) return BR_CB_MISSING;
    for (size_t i = 1; i < blk.vtx.size(); i++)
        if (tx_is_coinbase(*blk.vtx[i])) return BR_CB_MULTIPLE;
    for (size_t i = 0; i < blk.vtx.size(); i++) {
        i32 r = check_transaction(*blk.vtx[i], blk.nowit_size[i]);
        if (r != BR_OK) return r;
    }
    i64 sigops = 0;
    for (const auto& tx : blk.vtx) {
        for (const auto& in : tx->vin) sigops += sig_op_count(in.script_sig, false);
        for (const auto& out : tx->vout) sigops += sig_op_count(out.spk, false);
    }
    if (sigops * BLK_WITNESS_SCALE > BLK_MAX_SIGOPS_COST) return BR_BLK_SIGOPS;
    return BR_OK;
}

// --------------------------------------------------------------------------
// UTXO view (coins.h CCoinsViewCache role, dict-backed like
// models/validate.py CoinsView).

struct NCoin {
    i64 value;
    Bytes spk;
    i32 height;
    bool coinbase;
};

struct NView {
    std::unordered_map<std::string, NCoin> map;

    static std::string key(const u8 txid[32], u32 n) {
        std::string k(reinterpret_cast<const char*>(txid), 32);
        k.append(reinterpret_cast<const char*>(&n), 4);
        return k;
    }
};

inline i64 blk_subsidy(i64 height) {
    i64 halvings = height / BLK_HALVING_INTERVAL;
    if (halvings >= 64) return 0;
    return (50 * 100'000'000LL) >> halvings;
}

// ConnectBlock's accounting phases (validation.cpp:2155-2228 /
// models/validate.py phase 2 + coinbase cap): BIP30 scan, input
// existence/maturity/value rules, fees, sigop budget, per-input spent
// outputs. Fills blk.acct (including each tx's hash precompute with its
// spent outputs — the script phase needs them) and the per-tx
// spent-output digests (models/sigcache.py spent_digest stream). Does
// NOT mutate the view.
inline i32 block_accounting(NBlock& blk, const NView& view, i64 height,
                            u32 flags) {
    BlockAcct& A = blk.acct;
    A = BlockAcct();
    // The production driver runs check_block first (which rejects empty
    // blocks with bad-blk-length), but this entry is independently
    // reachable through the C ABI — the coinbase-cap read below must not
    // index an empty vtx (found by fuzz/fuzz_nat.cpp on its seed corpus).
    if (blk.vtx.empty()) return BR_BAD_LENGTH;
    std::unordered_map<std::string, NCoin> overlay;
    std::unordered_set<std::string> spent_keys;

    // BIP30 against the start-of-block view.
    for (size_t t = 0; t < blk.vtx.size(); t++)
        for (u32 n = 0; n < blk.vtx[t]->vout.size(); n++)
            if (view.map.count(NView::key(blk.txids[t].data(), n)))
                return BR_BIP30;

    A.spk_offs.push_back(0);
    A.spent_digests.resize(blk.vtx.size());
    for (auto& d : A.spent_digests) d.fill(0);

    for (size_t t = 0; t < blk.vtx.size(); t++) {
        NTx& tx = *blk.vtx[t];
        bool cb = tx_is_coinbase(tx);
        std::vector<NTxOut> spent;
        if (!cb) {
            spent.reserve(tx.vin.size());
            i64 value_in = 0;
            for (const auto& in : tx.vin) {
                std::string k = NView::key(in.prevout_hash, in.prevout_n);
                if (spent_keys.count(k)) return BR_INPUTS_MISSINGORSPENT;
                const NCoin* coin = nullptr;
                auto ito = overlay.find(k);
                if (ito != overlay.end()) {
                    coin = &ito->second;
                } else {
                    auto itv = view.map.find(k);
                    if (itv == view.map.end())
                        return BR_INPUTS_MISSINGORSPENT;
                    coin = &itv->second;
                }
                if (coin->coinbase && height - coin->height < BLK_COINBASE_MATURITY)
                    return BR_PREMATURE_COINBASE;
                if (coin->value < 0 || coin->value > BLK_MAX_MONEY)
                    return BR_INPUTVALUES_OUTOFRANGE;
                value_in += coin->value;
                if (value_in > BLK_MAX_MONEY) return BR_INPUTVALUES_OUTOFRANGE;
                spent.push_back(NTxOut{coin->value, coin->spk});
                spent_keys.insert(std::move(k));
            }
            i64 value_out = 0;
            for (const auto& out : tx.vout) value_out += out.value;
            if (value_in < value_out) return BR_IN_BELOWOUT;
            A.fees += value_in - value_out;
            if (A.fees < 0 || A.fees > BLK_MAX_MONEY) return BR_FEE_OUTOFRANGE;
        }
        {
            std::vector<const NTxOut*> sp;
            sp.reserve(spent.size());
            for (const auto& s : spent) sp.push_back(&s);
            A.sigop_cost += tx_sigop_cost(tx, sp, flags);
        }
        if (A.sigop_cost > BLK_MAX_SIGOPS_COST) return BR_BLK_SIGOPS;
        if (!cb) {
            // Record the script phase's per-input data + the tx's hash
            // precompute + the spent digest (sigcache.py spent_digest:
            // per output amt 8LE || len(spk) 4LE || spk).
            Sha256 h;
            for (size_t i = 0; i < tx.vin.size(); i++) {
                A.tx_index.push_back((i32)t);
                A.n_in.push_back((i32)i);
                A.amounts.push_back(spent[i].value);
                A.spk_blob.insert(A.spk_blob.end(), spent[i].spk.begin(),
                                  spent[i].spk.end());
                A.spk_offs.push_back((i64)A.spk_blob.size());
                u8 le[8];
                u64 v = (u64)spent[i].value;
                for (int j = 0; j < 8; j++) le[j] = u8(v >> (8 * j));
                h.write(le, 8);
                u32 sl = (u32)spent[i].spk.size();
                u8 l4[4] = {u8(sl), u8(sl >> 8), u8(sl >> 16), u8(sl >> 24)};
                h.write(l4, 4);
                h.write(spent[i].spk.data(), spent[i].spk.size());
            }
            h.finalize(A.spent_digests[t].data());
            precompute(tx, &spent);
        }
        // Overlay this tx's outputs for later txs of the same block.
        for (u32 n = 0; n < tx.vout.size(); n++)
            overlay[NView::key(blk.txids[t].data(), n)] =
                NCoin{tx.vout[n].value, tx.vout[n].spk, (i32)height, cb};
    }

    i64 cb_out = 0;
    for (const auto& out : blk.vtx[0]->vout) cb_out += out.value;
    if (cb_out > A.fees + blk_subsidy(height)) return BR_CB_AMOUNT;
    A.ready = true;
    return BR_OK;
}

// UpdateCoins over the whole block (coins.cpp / validate.py phase 4).
inline void view_apply_block(NView& view, const NBlock& blk, i64 height) {
    for (size_t t = 0; t < blk.vtx.size(); t++) {
        const NTx& tx = *blk.vtx[t];
        bool cb = tx_is_coinbase(tx);
        if (!cb)
            for (const auto& in : tx.vin)
                view.map.erase(NView::key(in.prevout_hash, in.prevout_n));
        for (u32 n = 0; n < tx.vout.size(); n++)
            view.map[NView::key(blk.txids[t].data(), n)] =
                NCoin{tx.vout[n].value, tx.vout[n].spk, (i32)height, cb};
    }
}

}  // namespace nat
