// Verbatim copy of native/eval.hpp, the JAX package's native host core, built by the port's ops/_build.py.
// EvalScript / VerifyScript: the native script machine.
// Twin of core/interpreter.py eval_script/verify_script (which mirrors
// script/interpreter.cpp:431-1259 and :1937-2056); byte-for-byte agreement
// asserted by tests/test_native_interp.py across the consensus vectors.
#pragma once

#include "interp.hpp"

namespace nat {

using Stack = std::vector<Bytes>;

struct EvalResult {
    bool ok;
    i32 err;
};

inline bool is_disabled_opcode(int op) {
    switch (op) {
        case OP_CAT: case OP_SUBSTR: case OP_LEFT: case OP_RIGHT:
        case OP_INVERT: case OP_AND: case OP_OR: case OP_XOR:
        case OP_2MUL: case OP_2DIV: case OP_MUL: case OP_DIV:
        case OP_MOD: case OP_LSHIFT: case OP_RSHIFT:
            return true;
        default:
            return false;
    }
}

inline bool is_upgradable_nop(int op) {
    return op == OP_NOP1 || (op >= OP_NOP4 && op <= OP_NOP10);
}

// O(1) IF/ELSE tracking (interpreter.cpp:297-342 ConditionStack).
struct CondStack {
    int size = 0;
    int first_false_pos = -1;

    bool empty() const { return size == 0; }
    bool all_true() const { return first_false_pos == -1; }
    void push_back(bool f) {
        if (first_false_pos == -1 && !f) first_false_pos = size;
        size++;
    }
    void pop_back() {
        size--;
        if (first_false_pos == size) first_false_pos = -1;
    }
    void toggle_top() {
        if (first_false_pos == -1) first_false_pos = size - 1;
        else if (first_false_pos == size - 1) first_false_pos = -1;
    }
};

// EvalChecksig (interpreter.cpp:345-429). Returns continue_ok; sets
// *success / *err.
inline bool eval_checksig(const Bytes& sig, const Bytes& pubkey,
                          const u8* sc_begin, size_t sc_len, ExecData& execdata,
                          u32 flags, Checker& checker, int sigversion,
                          bool* success, i32* err) {
    *err = SE_OK;
    if (sigversion == SV_BASE || sigversion == SV_WITNESS_V0) {
        Bytes script_code(sc_begin, sc_begin + sc_len);
        if (sigversion == SV_BASE) {
            int found = find_and_delete(script_code, push_data_enc(sig));
            if (found > 0 && (flags & F_CONST_SCRIPTCODE)) {
                *err = SE_SIG_FINDANDDELETE;
                return false;
            }
        }
        i32 e = check_signature_encoding(sig, flags);
        if (e == SE_OK) e = check_pubkey_encoding(pubkey, flags, sigversion);
        if (e != SE_OK) {
            *err = e;
            return false;
        }
        *success = checker.check_ecdsa_signature(sig, pubkey, script_code, sigversion);
        if (!*success && (flags & F_NULLFAIL) && !sig.empty()) {
            *err = SE_SIG_NULLFAIL;
            return false;
        }
        return true;
    }
    // Tapscript (EvalChecksigTapscript, interpreter.cpp:371-409).
    *success = !sig.empty();
    if (*success) {
        execdata.validation_weight_left -= VALIDATION_WEIGHT_PER_SIGOP_PASSED;
        if (execdata.validation_weight_left < 0) {
            *err = SE_TAPSCRIPT_VALIDATION_WEIGHT;
            return false;
        }
    }
    if (pubkey.empty()) {
        *err = SE_PUBKEYTYPE;
        return false;
    } else if (pubkey.size() == 32) {
        if (*success) {
            i32 e = SE_SCHNORR_SIG;
            if (!checker.check_schnorr_signature(sig, pubkey, sigversion,
                                                 execdata, &e)) {
                *err = e;
                return false;
            }
        }
    } else {
        if (flags & F_DISCOURAGE_UPGRADABLE_PUBKEYTYPE) {
            *err = SE_DISCOURAGE_UPGRADABLE_PUBKEYTYPE;
            return false;
        }
    }
    return true;
}

inline EvalResult eval_script(Stack& stack, const Bytes& script, u32 flags,
                              Checker& checker, int sigversion,
                              ExecData& execdata) {
    bool pre_tapscript = sigversion == SV_BASE || sigversion == SV_WITNESS_V0;
    if (pre_tapscript && script.size() > MAX_SCRIPT_SIZE)
        return {false, SE_SCRIPT_SIZE};

    Span sp = span_of(script);
    size_t pc = 0, pend = script.size();
    size_t pbegincodehash = 0;
    CondStack vf_exec;
    Stack altstack;
    int n_op_count = 0;
    bool require_minimal = (flags & F_MINIMALDATA) != 0;
    u32 opcode_pos = 0;
    execdata.codeseparator_pos = 0xFFFFFFFF;

    try {
        while (pc < pend) {
            bool f_exec = vf_exec.all_true();
            int opcode;
            const u8* pdata;
            size_t dlen;
            if (!decode_op(sp, pc, opcode, &pdata, &dlen))
                return {false, SE_BAD_OPCODE};
            bool is_push = opcode <= OP_PUSHDATA4;
            if (is_push && dlen > MAX_SCRIPT_ELEMENT_SIZE)
                return {false, SE_PUSH_SIZE};

            if (pre_tapscript) {
                if (opcode > OP_16) {
                    if (++n_op_count > MAX_OPS_PER_SCRIPT)
                        return {false, SE_OP_COUNT};
                }
            }
            if (is_disabled_opcode(opcode)) return {false, SE_DISABLED_OPCODE};
            if (opcode == OP_CODESEPARATOR && sigversion == SV_BASE &&
                (flags & F_CONST_SCRIPTCODE))
                return {false, SE_OP_CODESEPARATOR};

            if (f_exec && is_push) {
                if (require_minimal && !check_minimal_push(pdata, dlen, opcode))
                    return {false, SE_MINIMALDATA};
                stack.emplace_back(pdata, pdata + dlen);
            } else if (f_exec || (OP_IF <= opcode && opcode <= OP_ENDIF)) {
                switch (opcode) {
                    case OP_1NEGATE:
                    case 0x51: case 0x52: case 0x53: case 0x54: case 0x55:
                    case 0x56: case 0x57: case 0x58: case 0x59: case 0x5A:
                    case 0x5B: case 0x5C: case 0x5D: case 0x5E: case 0x5F:
                    case 0x60:
                        stack.push_back(script_num_encode((i64)opcode - (OP_1 - 1)));
                        break;

                    case OP_NOP:
                        break;

                    case OP_CLTV: {
                        if (!(flags & F_CLTV)) break;
                        if (stack.size() < 1) return {false, SE_INVALID_STACK_OPERATION};
                        i64 lock_time = script_num_decode(stack.back(), require_minimal, 5);
                        if (lock_time < 0) return {false, SE_NEGATIVE_LOCKTIME};
                        if (!checker.check_lock_time(lock_time))
                            return {false, SE_UNSATISFIED_LOCKTIME};
                        break;
                    }
                    case OP_CSV: {
                        if (!(flags & F_CSV)) break;
                        if (stack.size() < 1) return {false, SE_INVALID_STACK_OPERATION};
                        i64 sequence = script_num_decode(stack.back(), require_minimal, 5);
                        if (sequence < 0) return {false, SE_NEGATIVE_LOCKTIME};
                        if (!((u64)sequence & SEQ_DISABLE)) {
                            if (!checker.check_sequence(sequence))
                                return {false, SE_UNSATISFIED_LOCKTIME};
                        }
                        break;
                    }

                    case OP_NOP1: case OP_NOP4: case 0xB4: case 0xB5:
                    case 0xB6: case 0xB7: case 0xB8: case OP_NOP10:
                        if (flags & F_DISCOURAGE_UPGRADABLE_NOPS)
                            return {false, SE_DISCOURAGE_UPGRADABLE_NOPS};
                        break;

                    case OP_IF:
                    case OP_NOTIF: {
                        bool f_value = false;
                        if (f_exec) {
                            if (stack.size() < 1)
                                return {false, SE_UNBALANCED_CONDITIONAL};
                            const Bytes& vch = stack.back();
                            if (sigversion == SV_TAPSCRIPT) {
                                if (vch.size() > 1 || (vch.size() == 1 && vch[0] != 1))
                                    return {false, SE_TAPSCRIPT_MINIMALIF};
                            }
                            if (sigversion == SV_WITNESS_V0 && (flags & F_MINIMALIF)) {
                                if (vch.size() > 1) return {false, SE_MINIMALIF};
                                if (vch.size() == 1 && vch[0] != 1)
                                    return {false, SE_MINIMALIF};
                            }
                            f_value = script_num_to_bool(vch);
                            if (opcode == OP_NOTIF) f_value = !f_value;
                            stack.pop_back();
                        }
                        vf_exec.push_back(f_value);
                        break;
                    }
                    case OP_ELSE:
                        if (vf_exec.empty()) return {false, SE_UNBALANCED_CONDITIONAL};
                        vf_exec.toggle_top();
                        break;
                    case OP_ENDIF:
                        if (vf_exec.empty()) return {false, SE_UNBALANCED_CONDITIONAL};
                        vf_exec.pop_back();
                        break;

                    case OP_VERIFY:
                        if (stack.size() < 1) return {false, SE_INVALID_STACK_OPERATION};
                        if (script_num_to_bool(stack.back())) stack.pop_back();
                        else return {false, SE_VERIFY};
                        break;

                    case OP_RETURN:
                        return {false, SE_OP_RETURN};

                    case OP_TOALTSTACK:
                        if (stack.size() < 1) return {false, SE_INVALID_STACK_OPERATION};
                        altstack.push_back(std::move(stack.back()));
                        stack.pop_back();
                        break;
                    case OP_FROMALTSTACK:
                        if (altstack.size() < 1)
                            return {false, SE_INVALID_ALTSTACK_OPERATION};
                        stack.push_back(std::move(altstack.back()));
                        altstack.pop_back();
                        break;
                    case OP_2DROP:
                        if (stack.size() < 2) return {false, SE_INVALID_STACK_OPERATION};
                        stack.pop_back();
                        stack.pop_back();
                        break;
                    case OP_2DUP: {
                        if (stack.size() < 2) return {false, SE_INVALID_STACK_OPERATION};
                        Bytes a = stack[stack.size() - 2], b = stack[stack.size() - 1];
                        stack.push_back(std::move(a));
                        stack.push_back(std::move(b));
                        break;
                    }
                    case OP_3DUP: {
                        if (stack.size() < 3) return {false, SE_INVALID_STACK_OPERATION};
                        Bytes a = stack[stack.size() - 3], b = stack[stack.size() - 2],
                              c = stack[stack.size() - 1];
                        stack.push_back(std::move(a));
                        stack.push_back(std::move(b));
                        stack.push_back(std::move(c));
                        break;
                    }
                    case OP_2OVER: {
                        if (stack.size() < 4) return {false, SE_INVALID_STACK_OPERATION};
                        Bytes a = stack[stack.size() - 4], b = stack[stack.size() - 3];
                        stack.push_back(std::move(a));
                        stack.push_back(std::move(b));
                        break;
                    }
                    case OP_2ROT: {
                        if (stack.size() < 6) return {false, SE_INVALID_STACK_OPERATION};
                        Bytes a = stack[stack.size() - 6], b = stack[stack.size() - 5];
                        stack.erase(stack.end() - 6, stack.end() - 4);
                        stack.push_back(std::move(a));
                        stack.push_back(std::move(b));
                        break;
                    }
                    case OP_2SWAP:
                        if (stack.size() < 4) return {false, SE_INVALID_STACK_OPERATION};
                        std::swap(stack[stack.size() - 4], stack[stack.size() - 2]);
                        std::swap(stack[stack.size() - 3], stack[stack.size() - 1]);
                        break;
                    case OP_IFDUP:
                        if (stack.size() < 1) return {false, SE_INVALID_STACK_OPERATION};
                        if (script_num_to_bool(stack.back()))
                            stack.push_back(stack.back());
                        break;
                    case OP_DEPTH:
                        stack.push_back(script_num_encode((i64)stack.size()));
                        break;
                    case OP_DROP:
                        if (stack.size() < 1) return {false, SE_INVALID_STACK_OPERATION};
                        stack.pop_back();
                        break;
                    case OP_DUP:
                        if (stack.size() < 1) return {false, SE_INVALID_STACK_OPERATION};
                        stack.push_back(stack.back());
                        break;
                    case OP_NIP:
                        if (stack.size() < 2) return {false, SE_INVALID_STACK_OPERATION};
                        stack.erase(stack.end() - 2);
                        break;
                    case OP_OVER:
                        if (stack.size() < 2) return {false, SE_INVALID_STACK_OPERATION};
                        stack.push_back(stack[stack.size() - 2]);
                        break;
                    case OP_PICK:
                    case OP_ROLL: {
                        if (stack.size() < 2) return {false, SE_INVALID_STACK_OPERATION};
                        i64 n = clamp_int(script_num_decode(stack.back(), require_minimal));
                        stack.pop_back();
                        if (n < 0 || (u64)n >= stack.size())
                            return {false, SE_INVALID_STACK_OPERATION};
                        Bytes vch = stack[stack.size() - 1 - (size_t)n];
                        if (opcode == OP_ROLL)
                            stack.erase(stack.end() - 1 - (size_t)n);
                        stack.push_back(std::move(vch));
                        break;
                    }
                    case OP_ROT:
                        if (stack.size() < 3) return {false, SE_INVALID_STACK_OPERATION};
                        std::swap(stack[stack.size() - 3], stack[stack.size() - 2]);
                        std::swap(stack[stack.size() - 2], stack[stack.size() - 1]);
                        break;
                    case OP_SWAP:
                        if (stack.size() < 2) return {false, SE_INVALID_STACK_OPERATION};
                        std::swap(stack[stack.size() - 2], stack[stack.size() - 1]);
                        break;
                    case OP_TUCK: {
                        if (stack.size() < 2) return {false, SE_INVALID_STACK_OPERATION};
                        Bytes top = stack.back();
                        stack.insert(stack.end() - 2, std::move(top));
                        break;
                    }
                    case OP_SIZE:
                        if (stack.size() < 1) return {false, SE_INVALID_STACK_OPERATION};
                        stack.push_back(script_num_encode((i64)stack.back().size()));
                        break;

                    case OP_EQUAL:
                    case OP_EQUALVERIFY: {
                        if (stack.size() < 2) return {false, SE_INVALID_STACK_OPERATION};
                        bool f_equal = stack[stack.size() - 2] == stack[stack.size() - 1];
                        stack.pop_back();
                        stack.pop_back();
                        stack.push_back(f_equal ? Bytes{1} : Bytes{});
                        if (opcode == OP_EQUALVERIFY) {
                            if (f_equal) stack.pop_back();
                            else return {false, SE_EQUALVERIFY};
                        }
                        break;
                    }

                    case OP_1ADD: case OP_1SUB: case OP_NEGATE: case OP_ABS:
                    case OP_NOT: case OP_0NOTEQUAL: {
                        if (stack.size() < 1) return {false, SE_INVALID_STACK_OPERATION};
                        i64 bn = script_num_decode(stack.back(), require_minimal);
                        switch (opcode) {
                            case OP_1ADD: bn += 1; break;
                            case OP_1SUB: bn -= 1; break;
                            case OP_NEGATE: bn = -bn; break;
                            case OP_ABS: bn = bn < 0 ? -bn : bn; break;
                            case OP_NOT: bn = (bn == 0); break;
                            default: bn = (bn != 0); break;
                        }
                        stack.pop_back();
                        stack.push_back(script_num_encode(bn));
                        break;
                    }

                    case OP_ADD: case OP_SUB: case OP_BOOLAND: case OP_BOOLOR:
                    case OP_NUMEQUAL: case OP_NUMEQUALVERIFY:
                    case OP_NUMNOTEQUAL: case OP_LESSTHAN: case OP_GREATERTHAN:
                    case OP_LESSTHANOREQUAL: case OP_GREATERTHANOREQUAL:
                    case OP_MIN: case OP_MAX: {
                        if (stack.size() < 2) return {false, SE_INVALID_STACK_OPERATION};
                        i64 bn1 = script_num_decode(stack[stack.size() - 2], require_minimal);
                        i64 bn2 = script_num_decode(stack[stack.size() - 1], require_minimal);
                        i64 bn = 0;
                        switch (opcode) {
                            case OP_ADD: bn = bn1 + bn2; break;
                            case OP_SUB: bn = bn1 - bn2; break;
                            case OP_BOOLAND: bn = (bn1 != 0 && bn2 != 0); break;
                            case OP_BOOLOR: bn = (bn1 != 0 || bn2 != 0); break;
                            case OP_NUMEQUAL:
                            case OP_NUMEQUALVERIFY: bn = (bn1 == bn2); break;
                            case OP_NUMNOTEQUAL: bn = (bn1 != bn2); break;
                            case OP_LESSTHAN: bn = (bn1 < bn2); break;
                            case OP_GREATERTHAN: bn = (bn1 > bn2); break;
                            case OP_LESSTHANOREQUAL: bn = (bn1 <= bn2); break;
                            case OP_GREATERTHANOREQUAL: bn = (bn1 >= bn2); break;
                            case OP_MIN: bn = bn1 < bn2 ? bn1 : bn2; break;
                            default: bn = bn1 > bn2 ? bn1 : bn2; break;
                        }
                        stack.pop_back();
                        stack.pop_back();
                        stack.push_back(script_num_encode(bn));
                        if (opcode == OP_NUMEQUALVERIFY) {
                            if (script_num_to_bool(stack.back())) stack.pop_back();
                            else return {false, SE_NUMEQUALVERIFY};
                        }
                        break;
                    }

                    case OP_WITHIN: {
                        if (stack.size() < 3) return {false, SE_INVALID_STACK_OPERATION};
                        i64 bn1 = script_num_decode(stack[stack.size() - 3], require_minimal);
                        i64 bn2 = script_num_decode(stack[stack.size() - 2], require_minimal);
                        i64 bn3 = script_num_decode(stack[stack.size() - 1], require_minimal);
                        bool f_value = bn2 <= bn1 && bn1 < bn3;
                        stack.pop_back();
                        stack.pop_back();
                        stack.pop_back();
                        stack.push_back(f_value ? Bytes{1} : Bytes{});
                        break;
                    }

                    case OP_RIPEMD160: case OP_SHA1: case OP_SHA256:
                    case OP_HASH160: case OP_HASH256: {
                        if (stack.size() < 1) return {false, SE_INVALID_STACK_OPERATION};
                        Bytes vch = std::move(stack.back());
                        stack.pop_back();
                        u8 h32[32];
                        u8 h20[20];
                        switch (opcode) {
                            case OP_RIPEMD160:
                                ripemd160(vch.data(), vch.size(), h20);
                                stack.emplace_back(h20, h20 + 20);
                                break;
                            case OP_SHA1:
                                sha1(vch.data(), vch.size(), h20);
                                stack.emplace_back(h20, h20 + 20);
                                break;
                            case OP_SHA256:
                                sha256(vch.data(), vch.size(), h32);
                                stack.emplace_back(h32, h32 + 32);
                                break;
                            case OP_HASH160:
                                hash160(vch.data(), vch.size(), h20);
                                stack.emplace_back(h20, h20 + 20);
                                break;
                            default:
                                sha256d(vch.data(), vch.size(), h32);
                                stack.emplace_back(h32, h32 + 32);
                                break;
                        }
                        break;
                    }

                    case OP_CODESEPARATOR:
                        pbegincodehash = pc;
                        execdata.codeseparator_pos = opcode_pos;
                        break;

                    case OP_CHECKSIG:
                    case OP_CHECKSIGVERIFY: {
                        if (stack.size() < 2) return {false, SE_INVALID_STACK_OPERATION};
                        const Bytes& vch_sig = stack[stack.size() - 2];
                        const Bytes& vch_pub = stack[stack.size() - 1];
                        bool f_success = false;
                        i32 err;
                        if (!eval_checksig(vch_sig, vch_pub, sp.p + pbegincodehash,
                                           pend - pbegincodehash, execdata, flags,
                                           checker, sigversion, &f_success, &err))
                            return {false, err};
                        stack.pop_back();
                        stack.pop_back();
                        stack.push_back(f_success ? Bytes{1} : Bytes{});
                        if (opcode == OP_CHECKSIGVERIFY) {
                            if (f_success) stack.pop_back();
                            else return {false, SE_CHECKSIGVERIFY};
                        }
                        break;
                    }

                    case OP_CHECKSIGADD: {
                        if (pre_tapscript) return {false, SE_BAD_OPCODE};
                        if (stack.size() < 3) return {false, SE_INVALID_STACK_OPERATION};
                        Bytes sig = stack[stack.size() - 3];
                        i64 num = script_num_decode(stack[stack.size() - 2], require_minimal);
                        Bytes pubkey = stack[stack.size() - 1];
                        bool f_success = false;
                        i32 err;
                        if (!eval_checksig(sig, pubkey, sp.p + pbegincodehash,
                                           pend - pbegincodehash, execdata, flags,
                                           checker, sigversion, &f_success, &err))
                            return {false, err};
                        stack.pop_back();
                        stack.pop_back();
                        stack.pop_back();
                        stack.push_back(script_num_encode(num + (f_success ? 1 : 0)));
                        break;
                    }

                    case OP_CHECKMULTISIG:
                    case OP_CHECKMULTISIGVERIFY: {
                        if (sigversion == SV_TAPSCRIPT)
                            return {false, SE_TAPSCRIPT_CHECKMULTISIG};
                        size_t i = 1;
                        if (stack.size() < i) return {false, SE_INVALID_STACK_OPERATION};
                        i64 n_keys = clamp_int(
                            script_num_decode(stack[stack.size() - i], require_minimal));
                        if (n_keys < 0 || n_keys > MAX_PUBKEYS_PER_MULTISIG)
                            return {false, SE_PUBKEY_COUNT};
                        n_op_count += (int)n_keys;
                        if (n_op_count > MAX_OPS_PER_SCRIPT)
                            return {false, SE_OP_COUNT};
                        i += 1;
                        size_t ikey = i;
                        i64 ikey2 = n_keys + 2;
                        i += (size_t)n_keys;
                        if (stack.size() < i) return {false, SE_INVALID_STACK_OPERATION};
                        i64 n_sigs = clamp_int(
                            script_num_decode(stack[stack.size() - i], require_minimal));
                        if (n_sigs < 0 || n_sigs > n_keys)
                            return {false, SE_SIG_COUNT};
                        i += 1;
                        size_t isig = i;
                        i += (size_t)n_sigs;
                        if (stack.size() < i) return {false, SE_INVALID_STACK_OPERATION};

                        Bytes script_code(sp.p + pbegincodehash, sp.p + pend);
                        for (i64 k = 0; k < n_sigs; k++) {
                            const Bytes& vch_sig = stack[stack.size() - isig - (size_t)k];
                            if (sigversion == SV_BASE) {
                                int found =
                                    find_and_delete(script_code, push_data_enc(vch_sig));
                                if (found > 0 && (flags & F_CONST_SCRIPTCODE))
                                    return {false, SE_SIG_FINDANDDELETE};
                            }
                        }

                        // Deferring mode: pre-record every pairing the
                        // cursor walk below could reach (failure consumes a
                        // key, success consumes both, so key-idx - sig-idx
                        // stays in [0, nkeys-nsigs]) — one dispatch then
                        // answers any re-interpretation's oracle reads.
                        if (checker.mode == MODE_DEFER && checker.sess) {
                            i64 spare = n_keys - n_sigs;
                            Bytes sig_body, msg;
                            for (i64 s = 0; s < n_sigs; s++) {
                                const Bytes& vs =
                                    stack[stack.size() - isig - (size_t)s];
                                if (!checker.speculate_ecdsa_prep(
                                        vs, script_code, sigversion, &sig_body,
                                        &msg))
                                    continue;
                                for (i64 kk = s; kk <= s + spare; kk++) {
                                    const Bytes& vp =
                                        stack[stack.size() - ikey - (size_t)kk];
                                    checker.speculate_ecdsa_record(vp, sig_body,
                                                                   msg);
                                }
                            }
                        }

                        bool f_success = true;
                        while (f_success && n_sigs > 0) {
                            const Bytes& vch_sig = stack[stack.size() - isig];
                            const Bytes& vch_pub = stack[stack.size() - ikey];
                            i32 e = check_signature_encoding(vch_sig, flags);
                            if (e == SE_OK)
                                e = check_pubkey_encoding(vch_pub, flags, sigversion);
                            if (e != SE_OK) return {false, e};
                            bool f_ok = checker.check_ecdsa_signature(
                                vch_sig, vch_pub, script_code, sigversion);
                            if (f_ok) {
                                isig += 1;
                                n_sigs -= 1;
                            }
                            ikey += 1;
                            n_keys -= 1;
                            if (n_sigs > n_keys) f_success = false;
                        }

                        while (i > 1) {
                            i -= 1;
                            if (!f_success && (flags & F_NULLFAIL) && ikey2 == 0 &&
                                !stack.back().empty())
                                return {false, SE_SIG_NULLFAIL};
                            if (ikey2 > 0) ikey2 -= 1;
                            stack.pop_back();
                        }
                        if (stack.size() < 1) return {false, SE_INVALID_STACK_OPERATION};
                        if ((flags & F_NULLDUMMY) && !stack.back().empty())
                            return {false, SE_SIG_NULLDUMMY};
                        stack.pop_back();
                        stack.push_back(f_success ? Bytes{1} : Bytes{});
                        if (opcode == OP_CHECKMULTISIGVERIFY) {
                            if (f_success) stack.pop_back();
                            else return {false, SE_CHECKMULTISIGVERIFY};
                        }
                        break;
                    }

                    default:
                        return {false, SE_BAD_OPCODE};
                }
            }

            if (stack.size() + altstack.size() > MAX_STACK_SIZE)
                return {false, SE_STACK_SIZE};
            opcode_pos += 1;
        }
    } catch (const ScriptNumErr&) {
        return {false, SE_UNKNOWN_ERROR};
    }

    if (!vf_exec.empty()) return {false, SE_UNBALANCED_CONDITIONAL};
    return {true, SE_OK};
}

// --------------------------------------------------------------------------
// Witness program execution + taproot commitment (interpreter.cpp:1794-1935).

inline EvalResult execute_witness_script(const Stack& stack_in,
                                         const Bytes& exec_script, u32 flags,
                                         int sigversion, Checker& checker,
                                         ExecData& execdata) {
    Stack stack = stack_in;
    if (sigversion == SV_TAPSCRIPT) {
        Span sp = span_of(exec_script);
        size_t pos = 0;
        while (pos < sp.size()) {
            int opcode;
            const u8* d;
            size_t dl;
            if (!decode_op(sp, pos, opcode, &d, &dl)) return {false, SE_BAD_OPCODE};
            if (is_op_success(opcode)) {
                if (flags & F_DISCOURAGE_OP_SUCCESS)
                    return {false, SE_DISCOURAGE_OP_SUCCESS};
                return {true, SE_OK};
            }
        }
        if (stack.size() > MAX_STACK_SIZE) return {false, SE_STACK_SIZE};
    }
    for (const auto& elem : stack)
        if (elem.size() > MAX_SCRIPT_ELEMENT_SIZE) return {false, SE_PUSH_SIZE};
    EvalResult r = eval_script(stack, exec_script, flags, checker, sigversion, execdata);
    if (!r.ok) return r;
    if (stack.size() != 1) return {false, SE_CLEANSTACK};
    if (!script_num_to_bool(stack.back())) return {false, SE_EVAL_FALSE};
    return {true, SE_OK};
}

// Returns true + tapleaf hash on success.
inline bool verify_taproot_commitment(const Bytes& control, const Bytes& program,
                                      const Bytes& script, Checker& checker,
                                      Bytes* tapleaf_out) {
    size_t path_len =
        (control.size() - TAPROOT_CONTROL_BASE_SIZE) / TAPROOT_CONTROL_NODE_SIZE;
    Bytes p(control.begin() + 1, control.begin() + TAPROOT_CONTROL_BASE_SIZE);
    Bytes buf;
    buf.push_back(control[0] & TAPROOT_LEAF_MASK);
    put_string(buf, script);
    u8 k[32];
    TAG_TAPLEAF().hash(buf.data(), buf.size(), k);
    Bytes tapleaf(k, k + 32);
    for (size_t i = 0; i < path_len; i++) {
        const u8* node = control.data() + TAPROOT_CONTROL_BASE_SIZE +
                         TAPROOT_CONTROL_NODE_SIZE * i;
        u8 pair[64];
        if (std::memcmp(k, node, 32) < 0) {
            std::memcpy(pair, k, 32);
            std::memcpy(pair + 32, node, 32);
        } else {
            std::memcpy(pair, node, 32);
            std::memcpy(pair + 32, k, 32);
        }
        TAG_TAPBRANCH().hash(pair, 64, k);
    }
    Bytes tweak_in = p;
    tweak_in.insert(tweak_in.end(), k, k + 32);
    u8 t[32];
    TAG_TAPTWEAK().hash(tweak_in.data(), tweak_in.size(), t);
    Bytes q = program;
    Bytes tb(t, t + 32);
    if (!checker.verify_taproot_tweak(q, control[0] & 1, p, tb)) return false;
    *tapleaf_out = tapleaf;
    return true;
}

inline size_t witness_serialized_size(const std::vector<Bytes>& witness) {
    Bytes tmp;
    put_compact_size(tmp, witness.size());
    size_t total = tmp.size();
    for (const auto& item : witness) {
        Bytes t2;
        put_compact_size(t2, item.size());
        total += t2.size() + item.size();
    }
    return total;
}

inline EvalResult verify_witness_program(const std::vector<Bytes>& witness,
                                         int witversion, const Bytes& program,
                                         u32 flags, Checker& checker,
                                         bool is_p2sh_wrapped) {
    Stack stack(witness.begin(), witness.end());
    ExecData execdata;

    if (witversion == 0) {
        if (program.size() == 32) {
            if (stack.empty()) return {false, SE_WITNESS_PROGRAM_WITNESS_EMPTY};
            Bytes exec_script = std::move(stack.back());
            stack.pop_back();
            u8 h[32];
            sha256(exec_script.data(), exec_script.size(), h);
            if (std::memcmp(h, program.data(), 32) != 0)
                return {false, SE_WITNESS_PROGRAM_MISMATCH};
            return execute_witness_script(stack, exec_script, flags, SV_WITNESS_V0,
                                          checker, execdata);
        } else if (program.size() == 20) {
            if (stack.size() != 2) return {false, SE_WITNESS_PROGRAM_MISMATCH};
            Bytes exec_script;
            exec_script.push_back(OP_DUP);
            exec_script.push_back(OP_HASH160);
            Bytes pd = push_data_enc(program);
            put_bytes(exec_script, pd);
            exec_script.push_back(OP_EQUALVERIFY);
            exec_script.push_back(OP_CHECKSIG);
            return execute_witness_script(stack, exec_script, flags, SV_WITNESS_V0,
                                          checker, execdata);
        }
        return {false, SE_WITNESS_PROGRAM_WRONG_LENGTH};
    } else if (witversion == 1 && program.size() == 32 && !is_p2sh_wrapped) {
        if (!(flags & F_TAPROOT)) return {true, SE_OK};
        if (stack.empty()) return {false, SE_WITNESS_PROGRAM_WITNESS_EMPTY};
        if (stack.size() >= 2 && !stack.back().empty() &&
            stack.back()[0] == ANNEX_TAG) {
            Bytes annex = std::move(stack.back());
            stack.pop_back();
            Bytes ser;
            put_string(ser, annex);
            sha256(ser.data(), ser.size(), execdata.annex_hash);
            execdata.annex_present = true;
        }
        if (stack.size() == 1) {
            i32 err = SE_SCHNORR_SIG;
            if (!checker.check_schnorr_signature(stack[0], program, SV_TAPROOT,
                                                 execdata, &err))
                return {false, err};
            return {true, SE_OK};
        }
        Bytes control = std::move(stack.back());
        stack.pop_back();
        Bytes exec_script = std::move(stack.back());
        stack.pop_back();
        if (control.size() < TAPROOT_CONTROL_BASE_SIZE ||
            control.size() > TAPROOT_CONTROL_MAX_SIZE ||
            (control.size() - TAPROOT_CONTROL_BASE_SIZE) %
                    TAPROOT_CONTROL_NODE_SIZE !=
                0)
            return {false, SE_TAPROOT_WRONG_CONTROL_SIZE};
        Bytes tapleaf;
        if (!verify_taproot_commitment(control, program, exec_script, checker,
                                       &tapleaf))
            return {false, SE_WITNESS_PROGRAM_MISMATCH};
        execdata.tapleaf_hash = tapleaf;
        execdata.tapleaf_hash_init = true;
        if ((control[0] & TAPROOT_LEAF_MASK) == TAPROOT_LEAF_TAPSCRIPT) {
            execdata.validation_weight_left =
                (i64)witness_serialized_size(witness) + VALIDATION_WEIGHT_OFFSET;
            execdata.validation_weight_left_init = true;
            return execute_witness_script(stack, exec_script, flags, SV_TAPSCRIPT,
                                          checker, execdata);
        }
        if (flags & F_DISCOURAGE_UPGRADABLE_TAPROOT_VERSION)
            return {false, SE_DISCOURAGE_UPGRADABLE_TAPROOT_VERSION};
        return {true, SE_OK};
    }
    if (flags & F_DISCOURAGE_UPGRADABLE_WITNESS_PROGRAM)
        return {false, SE_DISCOURAGE_UPGRADABLE_WITNESS_PROGRAM};
    return {true, SE_OK};
}

inline EvalResult verify_script(const Bytes& script_sig,
                                const Bytes& script_pubkey,
                                const std::vector<Bytes>& witness, u32 flags,
                                Checker& checker) {
    bool had_witness = false;
    if ((flags & F_SIGPUSHONLY) && !is_push_only(script_sig))
        return {false, SE_SIG_PUSHONLY};

    Stack stack;
    ExecData execdata0;
    EvalResult r = eval_script(stack, script_sig, flags, checker, SV_BASE, execdata0);
    if (!r.ok) return r;
    Stack stack_copy;
    if (flags & F_P2SH) stack_copy = stack;
    ExecData execdata1;
    r = eval_script(stack, script_pubkey, flags, checker, SV_BASE, execdata1);
    if (!r.ok) return r;
    if (stack.empty()) return {false, SE_EVAL_FALSE};
    if (!script_num_to_bool(stack.back())) return {false, SE_EVAL_FALSE};

    int witversion;
    Bytes program;
    if (flags & F_WITNESS) {
        if (is_witness_program(script_pubkey, &witversion, &program)) {
            had_witness = true;
            if (!script_sig.empty()) return {false, SE_WITNESS_MALLEATED};
            r = verify_witness_program(witness, witversion, program, flags, checker,
                                       false);
            if (!r.ok) return r;
            stack.resize(1);
        }
    }

    if ((flags & F_P2SH) && is_p2sh(script_pubkey)) {
        if (!is_push_only(script_sig)) return {false, SE_SIG_PUSHONLY};
        stack = stack_copy;
        Bytes pubkey2 = std::move(stack.back());
        stack.pop_back();
        ExecData execdata2;
        r = eval_script(stack, pubkey2, flags, checker, SV_BASE, execdata2);
        if (!r.ok) return r;
        if (stack.empty()) return {false, SE_EVAL_FALSE};
        if (!script_num_to_bool(stack.back())) return {false, SE_EVAL_FALSE};

        if (flags & F_WITNESS) {
            if (is_witness_program(pubkey2, &witversion, &program)) {
                had_witness = true;
                if (script_sig != push_data_enc(pubkey2))
                    return {false, SE_WITNESS_MALLEATED_P2SH};
                r = verify_witness_program(witness, witversion, program, flags,
                                           checker, true);
                if (!r.ok) return r;
                stack.resize(1);
            }
        }
    }

    if (flags & F_CLEANSTACK) {
        if (stack.size() != 1) return {false, SE_CLEANSTACK};
    }
    if (flags & F_WITNESS) {
        if (!had_witness && !witness.empty())
            return {false, SE_WITNESS_UNEXPECTED};
    }
    return {true, SE_OK};
}

}  // namespace nat
