// Native (C++) corpus tokeniser of the zero_tpu_torch host data pipeline.
//
// A copy of zero_tpu/native/tokenizer.cpp. It replaces the pure-python
// first pass over a training corpus (data.py: Dataset._tokenize_serial and
// the forked _tokenize_parallel): std::thread workers tokenise memory-
// resident corpora and return flat int32 id buffers that python slices
// without a copy.
//
// Exact parity with vocab.py/data.py semantics:
//   * vocab: <pad>=0 <unk>=1 <eos>=2 reserved, then file tokens in order
//     (duplicates keep the first id); lookup misses map to <unk>
//   * lines are stripped and split on PYTHON unicode whitespace
//     (str.split semantics, incl. U+00A0, U+2000..200A, ...), not just
//     ASCII isspace
//   * a pair is skipped when either stripped line is empty; iteration
//     stops at the first exhausted file (data.py:_raw_pairs)
//   * each side truncates to max_len tokens then appends <eos>
//   * text-mode universal newlines ('\n', '\r\n', lone '\r'); blank vocab
//     lines insert a real '' token; invalid UTF-8 returns failure so the
//     caller falls back to the python path (which raises)
//
// Build: g++ -O3 -shared -fPIC -std=c++17 -pthread (see native/__init__.py).

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <string_view>
#include <thread>
#include <unordered_map>
#include <vector>

namespace {

// ---- python str.split() whitespace over UTF-8 ------------------------------

// code points python treats as whitespace (Py_UNICODE_ISSPACE)
inline bool is_space_cp(uint32_t cp) {
    switch (cp) {
        case 0x09: case 0x0A: case 0x0B: case 0x0C: case 0x0D:
        case 0x1C: case 0x1D: case 0x1E: case 0x1F:
        case 0x20: case 0x85: case 0xA0:
        case 0x1680:
        case 0x2000: case 0x2001: case 0x2002: case 0x2003: case 0x2004:
        case 0x2005: case 0x2006: case 0x2007: case 0x2008: case 0x2009:
        case 0x200A:
        case 0x2028: case 0x2029: case 0x202F:
        case 0x205F:
        case 0x3000:
            return true;
        default:
            return false;
    }
}

// decode one UTF-8 code point at s[i]; advances len_out bytes.
// invalid bytes are treated as latin-1 (never whitespace above 0xA0),
// which matches "not whitespace" for real corpus bytes.
inline uint32_t decode_utf8(const char* s, size_t n, size_t i,
                            size_t* len_out) {
    unsigned char c = static_cast<unsigned char>(s[i]);
    if (c < 0x80) { *len_out = 1; return c; }
    if ((c >> 5) == 0x6 && i + 1 < n) {
        *len_out = 2;
        return ((c & 0x1F) << 6) |
               (static_cast<unsigned char>(s[i + 1]) & 0x3F);
    }
    if ((c >> 4) == 0xE && i + 2 < n) {
        *len_out = 3;
        return ((c & 0x0F) << 12) |
               ((static_cast<unsigned char>(s[i + 1]) & 0x3F) << 6) |
               (static_cast<unsigned char>(s[i + 2]) & 0x3F);
    }
    if ((c >> 3) == 0x1E && i + 3 < n) {
        *len_out = 4;
        return ((c & 0x07) << 18) |
               ((static_cast<unsigned char>(s[i + 1]) & 0x3F) << 12) |
               ((static_cast<unsigned char>(s[i + 2]) & 0x3F) << 6) |
               (static_cast<unsigned char>(s[i + 3]) & 0x3F);
    }
    *len_out = 1;
    return c;
}

// split sv on python whitespace; append tokens (views) to out, up to
// max_tokens.
inline void split_ws(std::string_view sv, size_t max_tokens,
                     std::vector<std::string_view>* out) {
    const char* s = sv.data();
    size_t n = sv.size(), i = 0;
    while (i < n && out->size() < max_tokens) {
        size_t step;
        // skip whitespace
        while (i < n) {
            step = 1;
            unsigned char c = static_cast<unsigned char>(s[i]);
            if (c < 0x80) {
                if (!is_space_cp(c)) break;
                i += 1;
            } else {
                uint32_t cp = decode_utf8(s, n, i, &step);
                if (!is_space_cp(cp)) break;
                i += step;
            }
        }
        if (i >= n) break;
        size_t start = i;
        // consume token
        while (i < n) {
            size_t step = 1;
            unsigned char c = static_cast<unsigned char>(s[i]);
            uint32_t cp = c;
            if (c >= 0x80) cp = decode_utf8(s, n, i, &step);
            if (is_space_cp(cp)) break;
            i += step;
        }
        out->emplace_back(s + start, i - start);
    }
}

// strip python whitespace from both ends
inline std::string_view strip_ws(std::string_view sv) {
    const char* s = sv.data();
    size_t n = sv.size(), b = 0;
    while (b < n) {
        size_t step = 1;
        unsigned char c = static_cast<unsigned char>(s[b]);
        uint32_t cp = (c < 0x80) ? c : decode_utf8(s, n, b, &step);
        if (!is_space_cp(cp)) break;
        b += step;
    }
    size_t e = n;
    while (e > b) {
        // walk back over one code point: find its start byte
        size_t st = e - 1;
        while (st > b &&
               (static_cast<unsigned char>(s[st]) & 0xC0) == 0x80) {
            --st;
        }
        size_t step;
        uint32_t cp = decode_utf8(s, n, st, &step);
        if (st + step != e || !is_space_cp(cp)) break;
        e = st;
    }
    return sv.substr(b, e - b);
}

// ---- vocab ------------------------------------------------------------------

struct NativeVocab {
    std::string storage;  // vocab file bytes; string_view keys point here
    std::unordered_map<std::string_view, int32_t> word2id;
    int32_t unk = 1, eos = 2;
};

// ---- corpus result ----------------------------------------------------------

struct EncodedCorpus {
    std::vector<int32_t> src_ids, tgt_ids;
    std::vector<int64_t> src_off, tgt_off;  // n_pairs+1 offsets
};

struct LineIndex {
    const char* base;
    std::vector<std::pair<int64_t, int64_t>> lines;  // (start, len) per line
};

// Line terminators follow python text-mode universal newlines: '\n',
// '\r\n', and lone '\r' all end a line (vocab.py/data.py read files in
// text mode, so \r-terminated corpora must not misalign sentence pairs).
void index_lines(const std::string& buf, LineIndex* out) {
    out->base = buf.data();
    int64_t start = 0;
    const int64_t n = static_cast<int64_t>(buf.size());
    for (int64_t i = 0; i < n; ++i) {
        if (buf[i] == '\n') {
            out->lines.emplace_back(start, i - start);
            start = i + 1;
        } else if (buf[i] == '\r') {
            out->lines.emplace_back(start, i - start);
            if (i + 1 < n && buf[i + 1] == '\n') ++i;
            start = i + 1;
        }
    }
    if (start < n) out->lines.emplace_back(start, n - start);
}

// Strict UTF-8 validation matching python's file decode: rejects overlong
// encodings, surrogates, and code points > U+10FFFF. Files that fail take
// the python path, which raises UnicodeDecodeError exactly like the
// pure-python pipeline.
bool valid_utf8(const std::string& buf) {
    const unsigned char* s =
        reinterpret_cast<const unsigned char*>(buf.data());
    size_t n = buf.size(), i = 0;
    while (i < n) {
        unsigned char c = s[i];
        if (c < 0x80) { ++i; continue; }
        int len;
        uint32_t cp, min_cp;
        if ((c & 0xE0) == 0xC0) { len = 2; cp = c & 0x1F; min_cp = 0x80; }
        else if ((c & 0xF0) == 0xE0) { len = 3; cp = c & 0x0F;
                                       min_cp = 0x800; }
        else if ((c & 0xF8) == 0xF0) { len = 4; cp = c & 0x07;
                                       min_cp = 0x10000; }
        else return false;
        if (i + static_cast<size_t>(len) > n) return false;
        for (int j = 1; j < len; ++j) {
            if ((s[i + static_cast<size_t>(j)] & 0xC0) != 0x80) return false;
            cp = (cp << 6) | (s[i + static_cast<size_t>(j)] & 0x3F);
        }
        if (cp < min_cp || cp > 0x10FFFF) return false;
        if (cp >= 0xD800 && cp <= 0xDFFF) return false;
        i += static_cast<size_t>(len);
    }
    return true;
}

bool read_file(const char* path, std::string* out) {
    std::ifstream f(path, std::ios::binary);
    if (!f) return false;
    f.seekg(0, std::ios::end);
    out->resize(static_cast<size_t>(f.tellg()));
    f.seekg(0);
    f.read(out->data(), static_cast<std::streamsize>(out->size()));
    return true;
}

}  // namespace

extern "C" {

// Load a vocab file (one token per line, stripped); reserved symbols get
// ids 0/1/2 exactly like vocab.py. Returns an opaque handle (nullptr on
// read failure).
void* zt_vocab_load(const char* path) {
    auto* v = new NativeVocab();
    if (!read_file(path, &v->storage) || !valid_utf8(v->storage)) {
        delete v;
        return nullptr;
    }
    static const char* kReserved[3] = {"<pad>", "<unk>", "<eos>"};
    int32_t next_id = 0;
    for (const char* sym : kReserved) {
        v->word2id.emplace(std::string_view(sym), next_id++);
    }
    LineIndex idx;
    index_lines(v->storage, &idx);
    for (auto& [start, len] : idx.lines) {
        std::string_view tok =
            strip_ws(std::string_view(idx.base + start,
                                      static_cast<size_t>(len)));
        // vocab.py inserts the stripped line unconditionally, so a blank
        // line becomes a real '' token with its own id -- skipping it
        // would shift every subsequent id
        if (v->word2id.emplace(tok, next_id).second) ++next_id;
    }
    return v;
}

int64_t zt_vocab_size(void* vocab) {
    return static_cast<NativeVocab*>(vocab)->word2id.size();
}

void zt_vocab_free(void* vocab) {
    delete static_cast<NativeVocab*>(vocab);
}

// Tokenise a parallel corpus. Returns an opaque EncodedCorpus handle;
// use the zt_corpus_* accessors to read the flat buffers. nullptr on
// file-read failure.
void* zt_encode_corpus(const char* src_path, const char* tgt_path,
                       void* src_vocab, void* tgt_vocab,
                       int32_t max_len, int32_t n_threads) {
    auto* sv = static_cast<NativeVocab*>(src_vocab);
    auto* tv = static_cast<NativeVocab*>(tgt_vocab);
    std::string src_buf, tgt_buf;
    if (!read_file(src_path, &src_buf) || !read_file(tgt_path, &tgt_buf) ||
        !valid_utf8(src_buf) || !valid_utf8(tgt_buf)) {
        return nullptr;
    }
    LineIndex src_idx, tgt_idx;
    index_lines(src_buf, &src_idx);
    index_lines(tgt_buf, &tgt_idx);

    // pair selection mirrors _raw_pairs: stop at the shorter file, skip
    // pairs where either stripped side is empty
    const int64_t n_lines = std::min<int64_t>(src_idx.lines.size(),
                                              tgt_idx.lines.size());
    std::vector<std::pair<std::string_view, std::string_view>> pairs;
    pairs.reserve(static_cast<size_t>(n_lines));
    for (int64_t i = 0; i < n_lines; ++i) {
        auto [ss, sl] = src_idx.lines[static_cast<size_t>(i)];
        auto [ts, tl] = tgt_idx.lines[static_cast<size_t>(i)];
        std::string_view s = strip_ws(
            std::string_view(src_idx.base + ss, static_cast<size_t>(sl)));
        std::string_view t = strip_ws(
            std::string_view(tgt_idx.base + ts, static_cast<size_t>(tl)));
        if (s.empty() || t.empty()) continue;
        pairs.emplace_back(s, t);
    }

    const int64_t n_pairs = static_cast<int64_t>(pairs.size());
    auto* out = new EncodedCorpus();
    out->src_off.resize(static_cast<size_t>(n_pairs) + 1);
    out->tgt_off.resize(static_cast<size_t>(n_pairs) + 1);

    int nt = n_threads > 0 ? n_threads
                           : static_cast<int>(
                                 std::thread::hardware_concurrency());
    if (nt < 1) nt = 1;
    if (nt > n_pairs && n_pairs > 0) nt = static_cast<int>(n_pairs);

    struct Shard {
        std::vector<int32_t> src_ids, tgt_ids;
        std::vector<int32_t> src_lens, tgt_lens;
    };
    std::vector<Shard> shards(static_cast<size_t>(nt));

    auto work = [&](int w) {
        Shard& sh = shards[static_cast<size_t>(w)];
        int64_t lo = n_pairs * w / nt, hi = n_pairs * (w + 1) / nt;
        std::vector<std::string_view> toks;
        sh.src_lens.reserve(static_cast<size_t>(hi - lo));
        sh.tgt_lens.reserve(static_cast<size_t>(hi - lo));
        for (int64_t i = lo; i < hi; ++i) {
            const auto& [s, t] = pairs[static_cast<size_t>(i)];
            for (int side = 0; side < 2; ++side) {
                NativeVocab* v = side ? tv : sv;
                std::vector<int32_t>* ids = side ? &sh.tgt_ids : &sh.src_ids;
                std::vector<int32_t>* lens =
                    side ? &sh.tgt_lens : &sh.src_lens;
                toks.clear();
                split_ws(side ? t : s, static_cast<size_t>(max_len), &toks);
                for (auto tok : toks) {
                    auto it = v->word2id.find(tok);
                    ids->push_back(it == v->word2id.end() ? v->unk
                                                          : it->second);
                }
                ids->push_back(v->eos);
                lens->push_back(static_cast<int32_t>(toks.size()) + 1);
            }
        }
    };
    if (nt == 1) {
        work(0);
    } else {
        std::vector<std::thread> threads;
        threads.reserve(static_cast<size_t>(nt));
        for (int w = 0; w < nt; ++w) threads.emplace_back(work, w);
        for (auto& th : threads) th.join();
    }

    // merge shards into flat buffers + offsets
    int64_t s_total = 0, t_total = 0;
    for (auto& sh : shards) {
        s_total += static_cast<int64_t>(sh.src_ids.size());
        t_total += static_cast<int64_t>(sh.tgt_ids.size());
    }
    out->src_ids.resize(static_cast<size_t>(s_total));
    out->tgt_ids.resize(static_cast<size_t>(t_total));
    int64_t so = 0, to = 0, p = 0;
    out->src_off[0] = 0;
    out->tgt_off[0] = 0;
    for (auto& sh : shards) {
        if (!sh.src_ids.empty()) {
            std::memcpy(out->src_ids.data() + so, sh.src_ids.data(),
                        sh.src_ids.size() * sizeof(int32_t));
        }
        if (!sh.tgt_ids.empty()) {
            std::memcpy(out->tgt_ids.data() + to, sh.tgt_ids.data(),
                        sh.tgt_ids.size() * sizeof(int32_t));
        }
        for (size_t i = 0; i < sh.src_lens.size(); ++i) {
            so += sh.src_lens[i];
            to += sh.tgt_lens[i];
            out->src_off[static_cast<size_t>(p) + 1] = so;
            out->tgt_off[static_cast<size_t>(p) + 1] = to;
            ++p;
        }
    }
    return out;
}

int64_t zt_corpus_n_pairs(void* corpus) {
    return static_cast<int64_t>(
               static_cast<EncodedCorpus*>(corpus)->src_off.size()) - 1;
}

const int32_t* zt_corpus_src_ids(void* corpus) {
    return static_cast<EncodedCorpus*>(corpus)->src_ids.data();
}

const int32_t* zt_corpus_tgt_ids(void* corpus) {
    return static_cast<EncodedCorpus*>(corpus)->tgt_ids.data();
}

const int64_t* zt_corpus_src_off(void* corpus) {
    return static_cast<EncodedCorpus*>(corpus)->src_off.data();
}

const int64_t* zt_corpus_tgt_off(void* corpus) {
    return static_cast<EncodedCorpus*>(corpus)->tgt_off.data();
}

void zt_corpus_free(void* corpus) {
    delete static_cast<EncodedCorpus*>(corpus);
}

}  // extern "C"
