// CLIP byte-pair-encoding tokenizer, C++.
//
// The reference tokenizes prompts with the Python transformers CLIPTokenizer
// (scripts/inference.py:152) — a per-prompt host cost on the serving path.
// This is a native reimplementation of the same algorithm (OpenAI CLIP
// simple_tokenizer: bytes-to-unicode, lowercase + whitespace cleaning, the
// CLIP token regex, greedy rank-ordered BPE with </w> word markers), built
// only from merges.txt: the published vocab is exactly
//   [byte_chars] + [byte_chars + "</w>"] + [joined merges] + <|startoftext|>
//   + <|endoftext|>
// so no JSON parsing is needed and ids match the HF vocab.json.
//
// Unicode note: the \p{L}/\p{N} classes are approximated as
// [A-Za-z] + any UTF-8 byte >= 0x80 for letters and [0-9] for numbers —
// exact for ASCII and for scripts without ASCII digits/punctuation.
//
// Exported C API: fyc_tokenizer_create / _encode / _destroy.
//
// The PyTorch port's own copy of native/clip_tokenizer.cpp, built for the
// host by followyourclick_tpu_torch/ops/_build.build_host_library at first
// use (utils/native_tokenizer.py).

#include <cctype>
#include <cstdint>
#include <cstring>
#include <fstream>
#include <limits>
#include <map>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

// GPT-2 bytes_to_unicode: printable bytes map to themselves, the rest to
// U+0100.. — returned as UTF-8 strings per byte value.
std::vector<std::string> BytesToUnicode() {
  std::vector<int> bs;
  for (int b = '!'; b <= '~'; ++b) bs.push_back(b);
  for (int b = 0xA1; b <= 0xAC; ++b) bs.push_back(b);
  for (int b = 0xAE; b <= 0xFF; ++b) bs.push_back(b);
  std::vector<int> cs = bs;
  int n = 0;
  std::vector<bool> present(256, false);
  for (int b : bs) present[b] = true;
  for (int b = 0; b < 256; ++b) {
    if (!present[b]) {
      bs.push_back(b);
      cs.push_back(256 + n);
      ++n;
    }
  }
  std::vector<std::string> table(256);
  for (size_t i = 0; i < bs.size(); ++i) {
    int cp = cs[i];
    std::string utf8;
    if (cp < 0x80) {
      utf8 += static_cast<char>(cp);
    } else if (cp < 0x800) {
      utf8 += static_cast<char>(0xC0 | (cp >> 6));
      utf8 += static_cast<char>(0x80 | (cp & 0x3F));
    } else {
      utf8 += static_cast<char>(0xE0 | (cp >> 12));
      utf8 += static_cast<char>(0x80 | ((cp >> 6) & 0x3F));
      utf8 += static_cast<char>(0x80 | (cp & 0x3F));
    }
    table[bs[i]] = utf8;
  }
  return table;
}

struct PairHash {
  size_t operator()(const std::pair<std::string, std::string>& p) const {
    return std::hash<std::string>()(p.first) * 31 ^
           std::hash<std::string>()(p.second);
  }
};

class Tokenizer {
 public:
  explicit Tokenizer(const std::string& merges_path) {
    byte_table_ = BytesToUnicode();
    // vocab: single byte-chars, then byte-chars + </w>
    for (int b : ByteOrder()) AddToken(byte_table_[b]);
    for (int b : ByteOrder()) AddToken(byte_table_[b] + "</w>");

    std::ifstream f(merges_path);
    std::string line;
    bool first = true;
    int rank = 0;
    while (std::getline(f, line)) {
      if (!line.empty() && line.back() == '\r') line.pop_back();
      if (first && line.rfind("#version", 0) == 0) {
        first = false;
        continue;
      }
      first = false;
      if (line.empty()) continue;
      auto sp = line.find(' ');
      if (sp == std::string::npos) continue;
      std::string a = line.substr(0, sp);
      std::string b = line.substr(sp + 1);
      ranks_[{a, b}] = rank++;
      AddToken(a + b);
    }
    bos_ = AddToken("<|startoftext|>");
    eos_ = AddToken("<|endoftext|>");
  }

  int bos() const { return bos_; }
  int eos() const { return eos_; }

  std::vector<int> Encode(const std::string& raw) const {
    std::string text = Clean(raw);
    std::vector<int> ids;
    size_t i = 0;
    const size_t n = text.size();
    auto is_letter = [&](unsigned char c) {
      return std::isalpha(c) || c >= 0x80;
    };
    while (i < n) {
      unsigned char c = text[i];
      if (std::isspace(c)) {
        ++i;
        continue;
      }
      size_t start = i;
      // contractions: 's 't 're 've 'm 'll 'd
      if (c == '\'' && i + 1 < n) {
        static const char* kSuf[] = {"s", "t", "re", "ve", "m", "ll", "d"};
        bool matched = false;
        for (const char* s : kSuf) {
          size_t len = std::strlen(s);
          if (i + len < n + 1 && text.compare(i + 1, len, s) == 0) {
            // must not be followed by a letter (regex is greedy-alternation;
            // e.g. 'steam should not split as 's + team — CLIP's regex DOES
            // split 's first since alternation is ordered; match verbatim)
            i += 1 + len;
            matched = true;
            break;
          }
        }
        if (!matched) {
          // punctuation run
          while (i < n && !std::isspace((unsigned char)text[i]) &&
                 !is_letter(text[i]) && !std::isdigit((unsigned char)text[i]))
            ++i;
        }
      } else if (is_letter(c)) {
        while (i < n && is_letter(text[i])) ++i;
      } else if (std::isdigit(c)) {
        ++i;  // [\p{N}] matches ONE digit
      } else {
        while (i < n && !std::isspace((unsigned char)text[i]) &&
               !is_letter(text[i]) && !std::isdigit((unsigned char)text[i]))
          ++i;
      }
      BpeWord(text.substr(start, i - start), &ids);
    }
    return ids;
  }

 private:
  static std::vector<int> ByteOrder() {
    std::vector<int> bs;
    for (int b = '!'; b <= '~'; ++b) bs.push_back(b);
    for (int b = 0xA1; b <= 0xAC; ++b) bs.push_back(b);
    for (int b = 0xAE; b <= 0xFF; ++b) bs.push_back(b);
    std::vector<bool> present(256, false);
    for (int b : bs) present[b] = true;
    for (int b = 0; b < 256; ++b)
      if (!present[b]) bs.push_back(b);
    return bs;
  }

  int AddToken(const std::string& tok) {
    auto it = vocab_.find(tok);
    if (it != vocab_.end()) return it->second;
    int id = static_cast<int>(vocab_.size());
    vocab_.emplace(tok, id);
    return id;
  }

  static std::string Clean(const std::string& raw) {
    // whitespace_clean + lowercase (simple_tokenizer.py); ftfy/html repair
    // skipped (prompts are programmatic strings here)
    std::string out;
    bool in_space = false;
    for (char ch : raw) {
      unsigned char c = ch;
      if (std::isspace(c)) {
        in_space = true;
        continue;
      }
      if (in_space && !out.empty()) out += ' ';
      in_space = false;
      out += static_cast<char>(std::tolower(c));
    }
    return out;
  }

  void BpeWord(const std::string& word, std::vector<int>* ids) const {
    if (word.empty()) return;
    // special tokens pass through
    auto sp = vocab_.find(word);
    if (word.size() > 2 && word.front() == '<' && word.back() == '>' &&
        sp != vocab_.end()) {
      ids->push_back(sp->second);
      return;
    }
    std::vector<std::string> symbols;
    for (unsigned char c : word) symbols.push_back(byte_table_[c]);
    if (symbols.empty()) return;
    symbols.back() += "</w>";

    while (symbols.size() > 1) {
      int best_rank = std::numeric_limits<int>::max();
      for (size_t j = 0; j + 1 < symbols.size(); ++j) {
        auto it = ranks_.find({symbols[j], symbols[j + 1]});
        if (it != ranks_.end() && it->second < best_rank) {
          best_rank = it->second;
        }
      }
      if (best_rank == std::numeric_limits<int>::max()) break;
      // merge ALL occurrences of the best pair left-to-right
      std::vector<std::string> merged;
      size_t j = 0;
      while (j < symbols.size()) {
        if (j + 1 < symbols.size() &&
            ranks_.count({symbols[j], symbols[j + 1]}) &&
            ranks_.at({symbols[j], symbols[j + 1]}) == best_rank) {
          merged.push_back(symbols[j] + symbols[j + 1]);
          j += 2;
        } else {
          merged.push_back(symbols[j]);
          ++j;
        }
      }
      symbols.swap(merged);
    }
    for (const auto& s : symbols) {
      auto it = vocab_.find(s);
      if (it != vocab_.end()) {
        ids->push_back(it->second);
        continue;
      }
      // unknown symbol (possible only with a truncated/malformed merges
      // file): re-expand into its per-byte tokens instead of dropping it
      const bool endword =
          s.size() >= 4 && s.compare(s.size() - 4, 4, "</w>") == 0;
      const std::string core = endword ? s.substr(0, s.size() - 4) : s;
      std::vector<std::string> pieces;
      for (size_t pos = 0; pos < core.size();) {
        const unsigned char c = static_cast<unsigned char>(core[pos]);
        size_t len = (c < 0x80) ? 1 : (c < 0xE0) ? 2 : (c < 0xF0) ? 3 : 4;
        len = std::min(len, core.size() - pos);
        pieces.push_back(core.substr(pos, len));
        pos += len;
      }
      for (size_t k = 0; k < pieces.size(); ++k) {
        std::string p = pieces[k];
        if (endword && k + 1 == pieces.size()) p += "</w>";
        auto pit = vocab_.find(p);
        if (pit == vocab_.end() && endword && k + 1 == pieces.size()) {
          pit = vocab_.find(pieces[k]);  // vocab missing byte</w> variant
        }
        if (pit != vocab_.end()) ids->push_back(pit->second);
      }
    }
  }

  std::vector<std::string> byte_table_;
  std::unordered_map<std::string, int> vocab_;
  std::unordered_map<std::pair<std::string, std::string>, int, PairHash>
      ranks_;
  int bos_ = 0;
  int eos_ = 0;
};

}  // namespace

extern "C" {

void* fyc_tokenizer_create(const char* merges_path) {
  try {
    return new Tokenizer(merges_path);
  } catch (...) {
    return nullptr;
  }
}

void fyc_tokenizer_destroy(void* handle) {
  delete static_cast<Tokenizer*>(handle);
}

// Encodes text as <bos> tokens <eos>, truncates to max_len keeping <eos>
// last, pads with <eos> (the HF CLIPTokenizer pad token). Returns the
// unpadded length.
int fyc_tokenizer_encode(void* handle, const char* text, int* out,
                         int max_len) {
  auto* tok = static_cast<Tokenizer*>(handle);
  std::vector<int> ids = tok->Encode(text);
  std::vector<int> full;
  full.push_back(tok->bos());
  full.insert(full.end(), ids.begin(), ids.end());
  full.push_back(tok->eos());
  if (static_cast<int>(full.size()) > max_len) {
    full.resize(max_len);
    full.back() = tok->eos();
  }
  int n = static_cast<int>(full.size());
  for (int i = 0; i < max_len; ++i) {
    out[i] = i < n ? full[i] : tok->eos();
  }
  return n;
}

}  // extern "C"
