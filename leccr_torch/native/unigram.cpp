// Batch SentencePiece-Unigram tokenizer (C++), the XLM-R data-loader hot
// path.  Mirrors leccr_tpu/data/tokenizers.py::UnigramTokenizer exactly:
// whitespace-split words prefixed with the U+2581 marker, Viterbi max-sum
// segmentation over piece log-probs, <0xXX> byte-fallback (or <unk>) for
// uncovered characters, <s> ... </s> row layout.  Vocab/model parsing stays
// in Python (tokenizers.py handles both TSV and the sentencepiece protobuf
// wire format); the binding hands the resolved piece/score/id tables to
// uni_create via parallel arrays, so there is exactly one parser.
//
// The batch encode is threaded over rows (read-only tokenizer state).
// Parity with the Python implementation is enforced in
// tests/test_native_tokenizer.py.  Exposed through the same
// libleccr_native.so C ABI as wordpiece.cpp (ctypes binding:
// leccr_tpu/data/native_tokenizer.py).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <limits>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "unicode_tables.h"

namespace {

struct UniTokenizer {
  // scores stay double end-to-end: the Python tokenizer accumulates path
  // scores as Python floats (doubles), and near-tied segmentations are
  // common with duplicated scores in real sentencepiece vocabs
  std::unordered_map<std::string, std::pair<int32_t, double>> pieces;
  int32_t byte_ids[256];
  bool has_bytes = false;
  int32_t cls_id = 0, pad_id = 1, sep_id = 2, unk_id = 3;
  double unk_penalty = -10.0;
  size_t max_piece_bytes = 1;
  size_t max_piece_cps = 1;  // in codepoints, = Python max_piece_len
  bool lowercase = false;
};

// Python str.split() separator set (str.isspace() == true), enumerated
// over the full codepoint range; tokenizers.py::UnigramTokenizer.tokenize
// splits captions with str.split(), so the native path must match beyond
// ASCII (e.g. U+00A0 in generated captions).
bool uni_is_space(uint32_t cp) {
  switch (cp) {
    case 0x09: case 0x0A: case 0x0B: case 0x0C: case 0x0D:
    case 0x1C: case 0x1D: case 0x1E: case 0x1F:
    case 0x20: case 0x85: case 0xA0: case 0x1680:
    case 0x2028: case 0x2029: case 0x202F: case 0x205F: case 0x3000:
      return true;
    default:
      return cp >= 0x2000 && cp <= 0x200A;
  }
}

uint32_t uni_lower(uint32_t cp) {
  const size_t n = sizeof(kLowerMap) / sizeof(kLowerMap[0]);
  size_t lo = 0, hi = n;
  while (lo < hi) {
    size_t mid = (lo + hi) / 2;
    if (kLowerMap[mid].cp < cp) lo = mid + 1; else hi = mid;
  }
  return (lo < n && kLowerMap[lo].cp == cp) ? kLowerMap[lo].lower : cp;
}

void uni_append_cp(std::string& out, uint32_t cp) {
  if (cp < 0x80) {
    out.push_back(static_cast<char>(cp));
  } else if (cp < 0x800) {
    out.push_back(static_cast<char>(0xC0 | (cp >> 6)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else if (cp < 0x10000) {
    out.push_back(static_cast<char>(0xE0 | (cp >> 12)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  } else {
    out.push_back(static_cast<char>(0xF0 | (cp >> 18)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 12) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | ((cp >> 6) & 0x3F)));
    out.push_back(static_cast<char>(0x80 | (cp & 0x3F)));
  }
}

// decode UTF-8 into codepoints; invalid bytes pass through as U+FFFD
void uni_decode(const char* s, size_t len, std::vector<uint32_t>& out) {
  out.clear();
  size_t i = 0;
  while (i < len) {
    uint8_t b = static_cast<uint8_t>(s[i]);
    uint32_t cp;
    size_t n;
    if (b < 0x80) { cp = b; n = 1; }
    else if ((b >> 5) == 6) { cp = b & 0x1F; n = 2; }
    else if ((b >> 4) == 14) { cp = b & 0x0F; n = 3; }
    else if ((b >> 3) == 30) { cp = b & 0x07; n = 4; }
    else { out.push_back(0xFFFD); ++i; continue; }
    if (i + n > len) { out.push_back(0xFFFD); ++i; continue; }
    bool ok = true;
    for (size_t k = 1; k < n; ++k) {
      uint8_t c = static_cast<uint8_t>(s[i + k]);
      if ((c >> 6) != 2) { ok = false; break; }
      cp = (cp << 6) | (c & 0x3F);
    }
    if (!ok) { out.push_back(0xFFFD); ++i; continue; }
    out.push_back(cp);
    i += n;
  }
}

constexpr double kNegInf = -std::numeric_limits<double>::infinity();

// Viterbi max-sum over piece log-probs on codepoint boundaries; unseen
// characters fall back to their UTF-8 bytes (<0xXX> ids) or <unk>
// (tokenizers.py::UnigramTokenizer._viterbi semantics).
void uni_viterbi(const UniTokenizer& tok, const std::string& word,
                 std::vector<int32_t>& out) {
  // codepoint boundaries (byte offsets) of "▁word"
  std::vector<size_t> bounds;
  bounds.push_back(0);
  for (size_t i = 0; i < word.size();) {
    uint8_t b = static_cast<uint8_t>(word[i]);
    size_t n = b < 0x80 ? 1 : (b >> 5) == 6 ? 2 : (b >> 4) == 14 ? 3
               : (b >> 3) == 30 ? 4 : 1;
    i += n;
    if (i > word.size()) i = word.size();
    bounds.push_back(i);
  }
  const size_t n = bounds.size() - 1;  // codepoints
  std::vector<double> best(n + 1, kNegInf);
  std::vector<int32_t> back_start(n + 1, -1);
  // back_ids: piece id, or -2 meaning "byte-fallback of that codepoint"
  std::vector<int32_t> back_id(n + 1, -1);
  best[0] = 0.0;
  std::string sub;
  for (size_t end = 1; end <= n; ++end) {
    // ascending start with strict '>', exactly like tokenizers.py::_viterbi
    // — on a tied score the SMALLEST start (longest piece) wins
    size_t lo = end > tok.max_piece_cps ? end - tok.max_piece_cps : 0;
    for (size_t start = lo; start < end; ++start) {
      size_t blen = bounds[end] - bounds[start];
      if (blen > tok.max_piece_bytes) continue;
      if (best[start] == kNegInf) continue;
      sub.assign(word, bounds[start], blen);
      auto it = tok.pieces.find(sub);
      if (it == tok.pieces.end()) continue;
      double cand = best[start] + it->second.second;
      if (cand > best[end]) {
        best[end] = cand;
        back_start[end] = static_cast<int32_t>(start);
        back_id[end] = it->second.first;
      }
    }
    if (best[end] == kNegInf) {  // unk fallback: single codepoint
      best[end] = best[end - 1] + tok.unk_penalty;
      back_start[end] = static_cast<int32_t>(end - 1);
      back_id[end] = -2;
    }
  }
  // backtrack, then reverse
  std::vector<std::pair<int32_t, int32_t>> chunks;  // (id-or--2, cp index)
  size_t pos = n;
  while (pos > 0) {
    chunks.emplace_back(back_id[pos], static_cast<int32_t>(pos - 1));
    pos = static_cast<size_t>(back_start[pos]);
  }
  for (auto it = chunks.rbegin(); it != chunks.rend(); ++it) {
    if (it->first != -2) {
      out.push_back(it->first);
      continue;
    }
    size_t ci = static_cast<size_t>(it->second);
    if (tok.has_bytes) {
      for (size_t bo = bounds[ci]; bo < bounds[ci + 1]; ++bo) {
        int32_t id = tok.byte_ids[static_cast<uint8_t>(word[bo])];
        out.push_back(id < 0 ? tok.unk_id : id);
      }
    } else {
      out.push_back(tok.unk_id);
    }
  }
}

void uni_tokenize(const UniTokenizer& tok, const char* text,
                  std::vector<int32_t>& out) {
  const size_t len = std::strlen(text);
  std::string word;
  std::vector<uint32_t> cps;
  auto flush = [&]() {
    if (word.empty()) return;
    std::string marked = "\xE2\x96\x81";  // U+2581 ▁
    if (tok.lowercase) {
      uni_decode(word.data(), word.size(), cps);
      for (uint32_t cp : cps) {
        if (cp == 0x130) { uni_append_cp(marked, 'i');
                           uni_append_cp(marked, 0x307); continue; }
        uni_append_cp(marked, uni_lower(cp));
      }
    } else {
      marked += word;
    }
    uni_viterbi(tok, marked, out);
    word.clear();
  };
  // split on Python str.split()'s full Unicode whitespace set: the train
  // loader feeds RAW generated captions (no normalize_caption pass), so a
  // U+00A0 must separate words exactly as the Python eval path does
  size_t i = 0;
  while (i < len) {
    uint8_t b = static_cast<uint8_t>(text[i]);
    uint32_t cp;
    size_t nb;
    if (b < 0x80) { cp = b; nb = 1; }
    else if ((b >> 5) == 6) { cp = b & 0x1F; nb = 2; }
    else if ((b >> 4) == 14) { cp = b & 0x0F; nb = 3; }
    else if ((b >> 3) == 30) { cp = b & 0x07; nb = 4; }
    else { cp = 0xFFFD; nb = 1; }
    if (nb > 1) {
      if (i + nb > len) { cp = 0xFFFD; nb = 1; }
      else {
        for (size_t k = 1; k < nb; ++k) {
          uint8_t c = static_cast<uint8_t>(text[i + k]);
          if ((c >> 6) != 2) { cp = 0xFFFD; nb = 1; break; }
          cp = (cp << 6) | (c & 0x3F);
        }
      }
    }
    if (uni_is_space(cp)) flush();
    else word.append(text + i, nb);  // raw bytes preserved for valid UTF-8
    i += nb;
  }
  flush();
}

}  // namespace

extern "C" {

// pieces/ids/scores: n parallel entries; byte_ids: 256 ids (-1 = absent).
// lowercase uses per-codepoint simple lowering (no contextual Final_Sigma;
// the Python UnigramTokenizer uses str.lower() — callers keep
// lowercase=False for exact parity, which is the XLM-R default).
void* uni_create(const char** pieces, const int32_t* ids,
                 const double* scores, int n, const int32_t* byte_ids,
                 int32_t cls_id, int32_t pad_id, int32_t sep_id,
                 int32_t unk_id, double unk_penalty, int lowercase) {
  auto* tok = new UniTokenizer();
  tok->pieces.reserve(static_cast<size_t>(n) * 2);
  std::vector<uint32_t> cps;
  for (int i = 0; i < n; ++i) {
    std::string p(pieces[i]);
    tok->max_piece_bytes = std::max(tok->max_piece_bytes, p.size());
    uni_decode(p.data(), p.size(), cps);
    tok->max_piece_cps = std::max(tok->max_piece_cps, cps.size());
    tok->pieces.emplace(std::move(p), std::make_pair(ids[i], scores[i]));
  }
  for (int b = 0; b < 256; ++b) {
    tok->byte_ids[b] = byte_ids ? byte_ids[b] : -1;
    if (tok->byte_ids[b] >= 0) tok->has_bytes = true;
  }
  tok->cls_id = cls_id;
  tok->pad_id = pad_id;
  tok->sep_id = sep_id;
  tok->unk_id = unk_id;
  tok->unk_penalty = unk_penalty;
  tok->lowercase = lowercase != 0;
  return tok;
}

void uni_destroy(void* handle) { delete static_cast<UniTokenizer*>(handle); }

// Encode n texts into ids/mask [n, width] (int32, caller-allocated),
// truncated to max_len tokens incl. <s>/</s>.  Threaded over rows.
int uni_encode_batch(void* handle, const char** texts, int n, int max_len,
                     int width, int32_t* out_ids, int32_t* out_mask) {
  auto* tok = static_cast<UniTokenizer*>(handle);
  if (!tok || max_len < 2 || width < max_len) return -1;
  auto run = [&](int lo, int hi) {
    std::vector<int32_t> toks;
    for (int row = lo; row < hi; ++row) {
      toks.clear();
      uni_tokenize(*tok, texts[row], toks);
      if (static_cast<int>(toks.size()) > max_len - 2)
        toks.resize(max_len - 2);
      int32_t* idr = out_ids + static_cast<size_t>(row) * width;
      int32_t* mkr = out_mask + static_cast<size_t>(row) * width;
      int m = static_cast<int>(toks.size()) + 2;
      idr[0] = tok->cls_id;
      for (int j = 0; j < static_cast<int>(toks.size()); ++j)
        idr[j + 1] = toks[j];
      idr[m - 1] = tok->sep_id;
      for (int j = m; j < width; ++j) idr[j] = tok->pad_id;
      for (int j = 0; j < width; ++j) mkr[j] = j < m ? 1 : 0;
    }
  };
  int hw = static_cast<int>(std::thread::hardware_concurrency());
  int nt = std::min(std::max(hw, 1), std::min(n, 16));
  if (nt <= 1 || n < 1024) {
    run(0, n);
    return 0;
  }
  std::vector<std::thread> threads;
  int per = (n + nt - 1) / nt;
  for (int t = 0; t < nt; ++t) {
    int lo = t * per, hi = std::min(n, lo + per);
    if (lo >= hi) break;
    threads.emplace_back(run, lo, hi);
  }
  for (auto& th : threads) th.join();
  return 0;
}

}  // extern "C"
