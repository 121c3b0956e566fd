// Batch WordPiece tokenizer (C++), the native data-loader hot path.
//
// The reference tokenizes every batch with a Python HF BertTokenizer on the
// training critical path (reference image_Retrieval_caption.py:46-61;
// SURVEY.md §3.2 flags it as the host bottleneck).  leccr_tpu pre-tokenizes
// offline, and this library makes that pass (and any online/serving
// tokenization) native: basic tokenization (control stripping, whitespace,
// CJK isolation, full-Unicode lowercase + NFD accent stripping for uncased
// vocabs, punctuation split) + greedy longest-match WordPiece over a
// vocab.txt, emitting [CLS] ... [SEP] id rows padded to a fixed width.
//
// Uncased semantics match HF BasicTokenizer: per whitespace token,
// str.lower() (incl. the contextual Final_Sigma rule and U+0130 -> i+0x307)
// then NFD normalization with category-Mn marks dropped.  The Unicode
// tables are generated by gen_unicode_tables.py into unicode_tables.h.
//
// Exposed as a C ABI for ctypes (leccr_tpu/data/native_tokenizer.py).
// Parity with the Python WordPieceTokenizer (itself HF-parity-tested) is
// enforced in tests/test_native_tokenizer.py.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

#include "unicode_tables.h"

namespace {

struct Tokenizer {
  std::unordered_map<std::string, int32_t> vocab;
  bool lowercase = false;
  bool strip_accents = false;
  int32_t cls_id = -1, sep_id = -1, unk_id = -1, pad_id = 0;
};

// ---- Unicode property lookups (tables from unicode_tables.h) -------------

bool in_ranges(const UtRange* r, size_t n, uint32_t cp) {
  const UtRange* end = r + n;
  const UtRange* it = std::lower_bound(
      r, end, cp, [](const UtRange& a, uint32_t v) { return a.hi < v; });
  return it != end && cp >= it->lo;
}

bool is_mn(uint32_t cp) {
  return in_ranges(kMn, sizeof(kMn) / sizeof(kMn[0]), cp);
}

uint32_t simple_lower(uint32_t cp) {
  const UtLowerEntry* begin = kLowerMap;
  const UtLowerEntry* end = kLowerMap + sizeof(kLowerMap) / sizeof(kLowerMap[0]);
  const UtLowerEntry* it = std::lower_bound(
      begin, end, cp,
      [](const UtLowerEntry& a, uint32_t v) { return a.cp < v; });
  return (it != end && it->cp == cp) ? it->lower : cp;
}

// Per-character lowercase (HF semantics: PreTrainedTokenizer.tokenize
// lowercases char-by-char via re.sub before BasicTokenizer runs, so the
// contextual Final_Sigma rule never applies).  U+0130 is the only
// multi-char mapping.
void lower_word(const std::vector<uint32_t>& in, std::vector<uint32_t>& out) {
  out.clear();
  for (uint32_t cp : in) {
    if (cp == 0x130) {  // LATIN CAPITAL I WITH DOT ABOVE -> i + combining dot
      out.push_back('i');
      out.push_back(0x307);
      continue;
    }
    out.push_back(simple_lower(cp));
  }
}

// NFD + drop-Mn (HF _run_strip_accents).  Hangul decomposes algorithmically
// to Jamo (all category Lo, kept); other decompositions come from the
// precomputed Mn-stripped table.
void strip_accents_word(const std::vector<uint32_t>& in,
                        std::vector<uint32_t>& out) {
  out.clear();
  for (uint32_t cp : in) {
    if (is_mn(cp)) continue;
    if (cp >= 0xAC00 && cp <= 0xD7A3) {  // Hangul syllable -> L V (T)
      uint32_t s = cp - 0xAC00;
      out.push_back(0x1100 + s / 588);
      out.push_back(0x1161 + (s % 588) / 28);
      if (s % 28) out.push_back(0x11A7 + s % 28);
      continue;
    }
    const UtDecompEntry* begin = kDecomp;
    const UtDecompEntry* end = kDecomp + sizeof(kDecomp) / sizeof(kDecomp[0]);
    const UtDecompEntry* it = std::lower_bound(
        begin, end, cp,
        [](const UtDecompEntry& a, uint32_t v) { return a.cp < v; });
    if (it != end && it->cp == cp) {
      for (uint32_t j = 0; j < it->len; ++j)
        out.push_back(kDecompPool[it->off + j]);
    } else {
      out.push_back(cp);
    }
  }
}

// ---- UTF-8 helpers -------------------------------------------------------

// Decode next codepoint starting at s[i]; advances i past it.
uint32_t next_cp(const std::string& s, size_t& i) {
  unsigned char c = s[i];
  uint32_t cp;
  size_t len;
  if (c < 0x80) { cp = c; len = 1; }
  else if ((c >> 5) == 0x6) { cp = c & 0x1F; len = 2; }
  else if ((c >> 4) == 0xE) { cp = c & 0x0F; len = 3; }
  else if ((c >> 3) == 0x1E) { cp = c & 0x07; len = 4; }
  else { ++i; return 0xFFFD; }
  if (i + len > s.size()) { ++i; return 0xFFFD; }
  for (size_t k = 1; k < len; ++k) cp = (cp << 6) | (s[i + k] & 0x3F);
  i += len;
  return cp;
}

bool is_whitespace(uint32_t cp) {
  return cp == ' ' || cp == '\t' || cp == '\n' || cp == '\r' ||
         cp == 0x00A0 || cp == 0x2000 || (cp >= 0x2000 && cp <= 0x200A) ||
         cp == 0x202F || cp == 0x205F || cp == 0x3000;
}

bool is_control(uint32_t cp) {
  if (cp == '\t' || cp == '\n' || cp == '\r') return false;
  return cp < 0x20 || cp == 0x7F || (cp >= 0x80 && cp <= 0x9F) ||
         (cp >= 0x200B && cp <= 0x200F) || cp == 0xFEFF;
}

bool is_cjk(uint32_t cp) {
  return (cp >= 0x4E00 && cp <= 0x9FFF) || (cp >= 0x3400 && cp <= 0x4DBF) ||
         (cp >= 0x20000 && cp <= 0x2A6DF) || (cp >= 0x2A700 && cp <= 0x2B73F) ||
         (cp >= 0x2B740 && cp <= 0x2B81F) || (cp >= 0x2B820 && cp <= 0x2CEAF) ||
         (cp >= 0xF900 && cp <= 0xFAFF) || (cp >= 0x2F800 && cp <= 0x2FA1F);
}

bool is_punct(uint32_t cp) {
  // HF _is_punctuation: all non-letter/number ASCII plus Unicode category P
  if ((cp >= 33 && cp <= 47) || (cp >= 58 && cp <= 64) ||
      (cp >= 91 && cp <= 96) || (cp >= 123 && cp <= 126))
    return true;
  return in_ranges(kPunct, sizeof(kPunct) / sizeof(kPunct[0]), cp);
}

void append_cp(std::string& out, uint32_t cp) {
  if (cp < 0x80) out.push_back(static_cast<char>(cp));
  else if (cp < 0x800) {
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

// basic tokenization -> words (each word = utf8-encoded codepoint chunks).
// HF BasicTokenizer order: clean/whitespace/CJK split, then per token
// lower + strip-accents (uncased), then punctuation split.
void basic_tokenize(const Tokenizer& tok, const std::string& text,
                    std::vector<std::vector<std::string>>& words) {
  std::vector<std::vector<uint32_t>> raw;
  std::vector<uint32_t> cur;
  size_t i = 0;
  auto flush = [&]() {
    if (!cur.empty()) { raw.push_back(cur); cur.clear(); }
  };
  while (i < text.size()) {
    uint32_t cp = next_cp(text, i);
    if (cp == 0 || cp == 0xFFFD || is_control(cp)) continue;
    if (is_whitespace(cp)) { flush(); continue; }
    if (is_cjk(cp)) { flush(); raw.push_back({cp}); continue; }
    cur.push_back(cp);
  }
  flush();

  std::vector<uint32_t> lowered, stripped;
  std::vector<std::string> piece;
  for (const auto& w : raw) {
    const std::vector<uint32_t>* p = &w;
    if (tok.lowercase) { lower_word(*p, lowered); p = &lowered; }
    if (tok.strip_accents) { strip_accents_word(*p, stripped); p = &stripped; }
    piece.clear();
    for (uint32_t cp : *p) {
      std::string enc;
      append_cp(enc, cp);
      if (is_punct(cp)) {
        if (!piece.empty()) { words.push_back(piece); piece.clear(); }
        words.push_back({enc});
      } else {
        piece.push_back(enc);
      }
    }
    if (!piece.empty()) words.push_back(piece);
  }
}

// greedy longest-match wordpiece over codepoint chunks
void wordpiece(const Tokenizer& tok, const std::vector<std::string>& word,
               std::vector<int32_t>& out) {
  if (word.size() > 100) { out.push_back(tok.unk_id); return; }
  std::vector<int32_t> pieces;
  size_t start = 0;
  while (start < word.size()) {
    size_t end = word.size();
    int32_t id = -1;
    while (start < end) {
      std::string sub = start > 0 ? "##" : "";
      for (size_t k = start; k < end; ++k) sub += word[k];
      auto it = tok.vocab.find(sub);
      if (it != tok.vocab.end()) { id = it->second; break; }
      --end;
    }
    if (id < 0) { out.push_back(tok.unk_id); return; }
    pieces.push_back(id);
    start = end;
  }
  out.insert(out.end(), pieces.begin(), pieces.end());
}

}  // namespace

// bumped whenever the exported C contract changes (v2: wp_create's second
// argument became a flags word; v3: uni_* Unigram entry points +
// threaded batch encodes); the Python loader refuses stale builds instead
// of silently misreading flags / missing symbols.
extern "C" int wp_abi_version() { return 3; }

extern "C" {

// flags: bit0 = lowercase, bit1 = strip_accents (HF semantics: uncased
// vocabs set both; strip_accents alone is the HF strip_accents=True override)
void* wp_create(const char* vocab_path, int flags) {
  auto* tok = new Tokenizer();
  tok->lowercase = (flags & 1) != 0;
  tok->strip_accents = (flags & 2) != 0;
  std::ifstream in(vocab_path);
  if (!in) { delete tok; return nullptr; }
  std::string line;
  int32_t id = 0;
  while (std::getline(in, line)) {
    if (!line.empty() && line.back() == '\r') line.pop_back();
    tok->vocab.emplace(line, id++);
  }
  auto get = [&](const char* k) {
    auto it = tok->vocab.find(k);
    return it == tok->vocab.end() ? -1 : it->second;
  };
  tok->cls_id = get("[CLS]");
  tok->sep_id = get("[SEP]");
  tok->unk_id = get("[UNK]");
  int32_t pad = get("[PAD]");
  tok->pad_id = pad < 0 ? 0 : pad;
  if (tok->cls_id < 0 || tok->sep_id < 0 || tok->unk_id < 0) {
    delete tok;
    return nullptr;
  }
  return tok;
}

void wp_destroy(void* handle) { delete static_cast<Tokenizer*>(handle); }

// Encode n texts into ids/mask [n, width] (int32, caller-allocated).
// Sequences are truncated to max_len tokens incl. [CLS]/[SEP].
// Threaded over rows for large batches (tokenizer state is read-only).
int wp_encode_batch(void* handle, const char** texts, int n, int max_len,
                    int width, int32_t* out_ids, int32_t* out_mask) {
  auto* tok = static_cast<Tokenizer*>(handle);
  if (!tok || max_len < 2 || width < max_len) return -1;
  auto run = [&](int lo, int hi) {
    for (int row = lo; row < hi; ++row) {
      std::vector<std::vector<std::string>> words;
      basic_tokenize(*tok, texts[row], words);
      std::vector<int32_t> ids;
      ids.push_back(tok->cls_id);
      for (const auto& w : words) {
        wordpiece(*tok, w, ids);
        if (static_cast<int>(ids.size()) >= max_len - 1) break;
      }
      if (static_cast<int>(ids.size()) > max_len - 1)
        ids.resize(max_len - 1);
      ids.push_back(tok->sep_id);
      int32_t* idr = out_ids + static_cast<size_t>(row) * width;
      int32_t* mkr = out_mask + static_cast<size_t>(row) * width;
      for (int j = 0; j < width; ++j) {
        idr[j] = j < static_cast<int>(ids.size()) ? ids[j] : tok->pad_id;
        mkr[j] = j < static_cast<int>(ids.size()) ? 1 : 0;
      }
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
