// Byte-level BPE encoder: the port's copy of the JAX package's native encoder
// (cxrmate_tpu/tokenizer/native/bpe.cpp), opt-in through
// cxrmate_torch/tokenizer/native_binding.py:attach.
//
// Replaces the role HF `tokenizers` (Rust) plays for the reference: byte-exact
// encoding for the 30k BPE vocab. The Python layer handles special-token splitting
// and decode; this library implements the GPT-2 pre-tokenization scanner
// ('s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+)
// over UTF-8 with generated Unicode category tables, and ranked BPE merges over raw
// bytes with a per-token memo. Exposed as a C ABI consumed via ctypes.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include "unicode_tables.h"  // committed: kLetterRanges / kNumberRanges / kSpaceRanges

namespace {

struct PairHash {
    size_t operator()(const std::pair<int32_t, int32_t>& p) const {
        return std::hash<int64_t>()((int64_t(p.first) << 32) | uint32_t(p.second));
    }
};

struct Engine {
    // vocab: byte-string -> id
    std::unordered_map<std::string, int32_t> vocab;
    // merge ranks keyed by (left_id, right_id)
    std::unordered_map<std::pair<int32_t, int32_t>, int32_t, PairHash> ranks;
    // merged token id for a pair
    std::unordered_map<std::pair<int32_t, int32_t>, int32_t, PairHash> merged;
    std::vector<std::string> id_to_token;
    int32_t unk_id = 0;
    // memo: pre-token bytes -> encoded ids
    std::unordered_map<std::string, std::vector<int32_t>> memo;
};

bool in_ranges(uint32_t cp, const uint32_t (*ranges)[2], size_t n) {
    size_t lo = 0, hi = n;
    while (lo < hi) {
        size_t mid = (lo + hi) / 2;
        if (cp > ranges[mid][1]) {
            lo = mid + 1;
        } else if (cp < ranges[mid][0]) {
            hi = mid;
        } else {
            return true;
        }
    }
    return false;
}

bool is_letter(uint32_t cp) { return in_ranges(cp, kLetterRanges, kNumLetterRanges); }
bool is_number(uint32_t cp) { return in_ranges(cp, kNumberRanges, kNumNumberRanges); }
bool is_space(uint32_t cp) { return in_ranges(cp, kSpaceRanges, kNumSpaceRanges); }

// Decode one UTF-8 codepoint at s[i]; advances i. Invalid bytes are returned as
// 0xDC00+byte (never letter/number/space → grouped into the "other" class).
uint32_t next_cp(const unsigned char* s, size_t n, size_t& i) {
    unsigned char c = s[i];
    if (c < 0x80) { i += 1; return c; }
    if ((c >> 5) == 0x6 && i + 1 < n) {
        uint32_t cp = ((c & 0x1F) << 6) | (s[i + 1] & 0x3F);
        i += 2; return cp;
    }
    if ((c >> 4) == 0xE && i + 2 < n) {
        uint32_t cp = ((c & 0x0F) << 12) | ((s[i + 1] & 0x3F) << 6) | (s[i + 2] & 0x3F);
        i += 3; return cp;
    }
    if ((c >> 3) == 0x1E && i + 3 < n) {
        uint32_t cp = ((c & 0x07) << 18) | ((s[i + 1] & 0x3F) << 12) |
                      ((s[i + 2] & 0x3F) << 6) | (s[i + 3] & 0x3F);
        i += 4; return cp;
    }
    i += 1;
    return 0xDC00 + c;
}

// GPT-2 pre-tokenization: emit [start, end) byte spans.
void pretokenize(const unsigned char* s, size_t n, std::vector<std::pair<size_t, size_t>>& spans) {
    size_t i = 0;
    while (i < n) {
        size_t start = i;
        // contractions: '(s|t|m|d) | '(re|ve|ll)
        if (s[i] == '\'' && i + 1 < n) {
            unsigned char a = s[i + 1];
            if (a == 's' || a == 't' || a == 'm' || a == 'd') {
                spans.emplace_back(i, i + 2);
                i += 2;
                continue;
            }
            if (i + 2 < n) {
                unsigned char b = s[i + 2];
                if ((a == 'r' && b == 'e') || (a == 'v' && b == 'e') || (a == 'l' && b == 'l')) {
                    spans.emplace_back(i, i + 3);
                    i += 3;
                    continue;
                }
            }
        }
        size_t j = i;
        uint32_t cp = next_cp(s, n, j);
        bool leading_space = (cp == ' ');
        size_t k = j;
        uint32_t cp2 = cp;
        if (leading_space && j < n) {
            size_t jj = j;
            cp2 = next_cp(s, n, jj);
            if (is_letter(cp2) || is_number(cp2) || !(is_space(cp2))) {
                k = jj;
            } else {
                cp2 = cp;  // space followed by space: fall through to \s+ branch
                k = j;
            }
        }
        if ((leading_space && k != j) || (!leading_space)) {
            uint32_t cls = cp2;
            if (is_letter(cls)) {
                // ?\p{L}+
                size_t end = k;
                while (end < n) {
                    size_t t = end;
                    uint32_t c2 = next_cp(s, n, t);
                    if (!is_letter(c2)) break;
                    end = t;
                }
                spans.emplace_back(start, end);
                i = end;
                continue;
            }
            if (is_number(cls)) {
                size_t end = k;
                while (end < n) {
                    size_t t = end;
                    uint32_t c2 = next_cp(s, n, t);
                    if (!is_number(c2)) break;
                    end = t;
                }
                spans.emplace_back(start, end);
                i = end;
                continue;
            }
            if (!is_space(cls)) {
                // ?[^\s\p{L}\p{N}]+
                size_t end = k;
                while (end < n) {
                    size_t t = end;
                    uint32_t c2 = next_cp(s, n, t);
                    if (is_space(c2) || is_letter(c2) || is_number(c2)) break;
                    end = t;
                }
                spans.emplace_back(start, end);
                i = end;
                continue;
            }
        }
        // whitespace run: \s+(?!\S) | \s+
        size_t end = i;
        size_t last_ws_start = i;
        while (end < n) {
            size_t t = end;
            uint32_t c2 = next_cp(s, n, t);
            if (!is_space(c2)) break;
            last_ws_start = end;
            end = t;
        }
        if (end < n && end > i) {
            // followed by non-space: leave the final whitespace char to prefix the
            // next token ( \s+(?!\S) )
            if (last_ws_start > i) {
                spans.emplace_back(i, last_ws_start);
            }
            i = last_ws_start;
            // single whitespace char will be consumed as the optional-space prefix
            // of the next token if it is a plain ' ', else as its own \s+ token
            if (s[i] == ' ') {
                continue;  // handled by the " ?" in the next scan iteration
            }
            size_t t = i;
            next_cp(s, n, t);
            spans.emplace_back(i, t);
            i = t;
        } else {
            spans.emplace_back(i, end);
            i = end;
        }
    }
}

void bpe_encode_word(Engine* e, const std::string& word, std::vector<int32_t>& out) {
    auto it = e->memo.find(word);
    if (it != e->memo.end()) {
        out.insert(out.end(), it->second.begin(), it->second.end());
        return;
    }
    // start from single bytes; with no model unk (unk_id < 0, HF BPE
    // unk_token null — the reference recipe) unknown bytes are dropped HERE,
    // before merging, so their neighbours become adjacent and may merge
    std::vector<int32_t> ids;
    ids.reserve(word.size());
    for (unsigned char c : word) {
        auto vit = e->vocab.find(std::string(1, char(c)));
        if (vit == e->vocab.end()) {
            if (e->unk_id >= 0) ids.push_back(-1);
        } else {
            ids.push_back(vit->second);
        }
    }
    while (ids.size() > 1) {
        int32_t best_rank = INT32_MAX;
        size_t best_i = 0;
        for (size_t i = 0; i + 1 < ids.size(); ++i) {
            if (ids[i] < 0 || ids[i + 1] < 0) continue;
            auto rit = e->ranks.find({ids[i], ids[i + 1]});
            if (rit != e->ranks.end() && rit->second < best_rank) {
                best_rank = rit->second;
                best_i = i;
            }
        }
        if (best_rank == INT32_MAX) break;
        int32_t m = e->merged[{ids[best_i], ids[best_i + 1]}];
        ids[best_i] = m;
        ids.erase(ids.begin() + best_i + 1);
    }
    if (e->unk_id >= 0) {
        for (auto& id : ids) {
            if (id < 0) id = e->unk_id;
        }
    } else {
        // drop mode: negatives only arise from a malformed merge table
        // (merge output missing from vocab); never emit them
        ids.erase(std::remove_if(ids.begin(), ids.end(),
                                 [](int32_t id) { return id < 0; }),
                  ids.end());
    }
    if (e->memo.size() < (1u << 18)) e->memo.emplace(word, ids);
    out.insert(out.end(), ids.begin(), ids.end());
}

}  // namespace

extern "C" {

// vocab_blob: token entries as <u32 len><bytes>, ids implicit 0..n-1 is NOT assumed:
// ids passed separately. merges: pairs of token ids (left,right) in rank order.
void* bpe_create(const uint8_t* vocab_blob, size_t vocab_blob_len, const int32_t* vocab_ids,
                 int32_t n_vocab, const int32_t* merge_pairs, int32_t n_merges, int32_t unk_id) {
    auto* e = new Engine();
    e->unk_id = unk_id;
    size_t off = 0;
    int32_t max_id = 0;
    std::vector<std::string> tokens;
    tokens.reserve(n_vocab);
    for (int32_t i = 0; i < n_vocab; ++i) {
        uint32_t len;
        std::memcpy(&len, vocab_blob + off, 4);
        off += 4;
        tokens.emplace_back(reinterpret_cast<const char*>(vocab_blob + off), len);
        off += len;
        if (vocab_ids[i] > max_id) max_id = vocab_ids[i];
    }
    e->id_to_token.resize(max_id + 1);
    for (int32_t i = 0; i < n_vocab; ++i) {
        e->vocab.emplace(tokens[i], vocab_ids[i]);
        e->id_to_token[vocab_ids[i]] = tokens[i];
    }
    for (int32_t r = 0; r < n_merges; ++r) {
        int32_t a = merge_pairs[2 * r], b = merge_pairs[2 * r + 1];
        std::pair<int32_t, int32_t> key{a, b};
        if (e->ranks.find(key) == e->ranks.end()) {
            e->ranks.emplace(key, r);
            const std::string m = e->id_to_token[a] + e->id_to_token[b];
            auto vit = e->vocab.find(m);
            e->merged.emplace(key, vit == e->vocab.end() ? unk_id : vit->second);
        }
    }
    return e;
}

int32_t bpe_encode(void* handle, const uint8_t* text, size_t text_len, int32_t* out, int32_t max_out) {
    auto* e = static_cast<Engine*>(handle);
    std::vector<std::pair<size_t, size_t>> spans;
    spans.reserve(text_len / 4 + 4);
    pretokenize(text, text_len, spans);
    std::vector<int32_t> ids;
    ids.reserve(text_len / 3 + 4);
    for (auto& sp : spans) {
        bpe_encode_word(e, std::string(reinterpret_cast<const char*>(text) + sp.first,
                                       sp.second - sp.first),
                        ids);
    }
    int32_t n = int32_t(ids.size() < size_t(max_out) ? ids.size() : size_t(max_out));
    std::memcpy(out, ids.data(), n * sizeof(int32_t));
    return int32_t(ids.size());
}

void bpe_free(void* handle) { delete static_cast<Engine*>(handle); }
}
