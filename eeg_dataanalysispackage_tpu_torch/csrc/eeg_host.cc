// Native host-side kernels of the PyTorch port's input pipeline.
//
// The native equivalent of the closed `eegloader-hdfs` jar's hot path
// (reference usage: OffLineDataProvider.java:167-196): demux of
// multiplexed int16 BrainVision samples into per-channel scaled
// float64 rows, and the stimulus-locked window gather + float32
// baseline correction (Baseline.java:29-42, EpochHolder.java:75-91),
// plus the .vhdr/.vmrk parsers and the class-balance scan. These are
// the host-side loops that feed the card's staging buffers. The source
// is a copy of the JAX package's, kept with the same entry points;
// io/native.py builds it with g++ at first use and binds it by ctypes.
//
// Bit-exactness contract with the Python/numpy paths
// (io/brainvision.py, epochs/extractor.py):
//  - int16 -> float32, scaled by float32 resolution, widened to double;
//  - baseline = sequential float32 left-fold sum of the first `pre`
//    samples divided by float32(pre); subtraction in float32;
//  - windows running past the end of the recording zero-pad (Java's
//    Arrays.copyOfRange semantics); windows starting out of range are
//    marked invalid.
// Compiled without -ffast-math so float arithmetic is strict IEEE.

#include <algorithm>
#include <cctype>
#include <cerrno>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

// ---------------------------------------------------------------------------
// BrainVision .vhdr/.vmrk parsing (the header-file half of the closed
// eegloader-hdfs jar: getChannelInfo / readMarkerList,
// OffLineDataProvider.java:167-196). Semantics are kept in lockstep
// with the Python fallback parser (io/brainvision.py::_parse_ini /
// parse_vhdr / parse_vmrk); any input the C++ side cannot represent
// exactly (numeric parse failure, field overflow) returns a negative
// status so the binding falls back to Python instead of diverging.
// ---------------------------------------------------------------------------

namespace {

struct IniSection {
  std::string name;
  std::vector<std::pair<std::string, std::string>> kv;
};

bool is_space(char c) { return std::isspace(static_cast<unsigned char>(c)); }

std::string trim_ws(const std::string& s) {
  size_t b = 0, e = s.size();
  while (b < e && is_space(s[b])) ++b;
  while (e > b && is_space(s[e - 1])) --e;
  return s.substr(b, e - b);
}

IniSection* find_section(std::vector<IniSection>& secs, const std::string& n) {
  for (auto& s : secs)
    if (s.name == n) return &s;
  return nullptr;
}

const std::string* find_key(const IniSection* s, const std::string& key) {
  if (!s) return nullptr;
  for (const auto& p : s->kv)
    if (p.first == key) return &p.second;
  return nullptr;
}

// Mirrors io/brainvision.py::_parse_ini: sections, key=value with keys
// free of '=' and ';', ';'-led lines skipped, duplicate sections
// merged, duplicate keys overwritten in place (dict semantics).
void parse_ini(const char* text, int64_t len, std::vector<IniSection>& out) {
  IniSection* current = nullptr;
  int64_t i = 0;
  while (i < len) {
    int64_t j = i;
    while (j < len && text[j] != '\n') ++j;
    std::string line(text + i, text + j);
    i = j + 1;
    // strip('\r\n') on both ends
    size_t b = 0, e = line.size();
    while (b < e && (line[b] == '\r' || line[b] == '\n')) ++b;
    while (e > b && (line[e - 1] == '\r' || line[e - 1] == '\n')) --e;
    line = line.substr(b, e - b);

    // skip blank lines and ';' comments (after lstrip of whitespace)
    size_t first = 0;
    while (first < line.size() && is_space(line[first])) ++first;
    if (first == line.size() || line[first] == ';') continue;

    // section header: ^\[(.+)\]\s*$ on the whitespace-stripped line
    const std::string stripped = trim_ws(line);
    if (stripped.size() >= 3 && stripped.front() == '[' &&
        stripped.back() == ']') {
      const std::string name = stripped.substr(1, stripped.size() - 2);
      current = find_section(out, name);
      if (!current) {
        out.push_back(IniSection{name, {}});
        current = &out.back();
      }
      continue;
    }
    if (!current) continue;

    // key=value: ^([^=;]+)=(.*)$ — key up to the first '=', no ';'
    const size_t eq = line.find('=');
    if (eq == std::string::npos || eq == 0) continue;
    if (line.find(';') < eq) continue;
    const std::string key = trim_ws(line.substr(0, eq));
    if (key.empty()) continue;  // key was all whitespace
    std::string value = line.substr(eq + 1);
    bool replaced = false;
    for (auto& p : current->kv) {
      if (p.first == key) {
        p.second = std::move(value);
        replaced = true;
        break;
      }
    }
    if (!replaced) current->kv.emplace_back(key, std::move(value));
  }
}

void split_commas(const std::string& s, std::vector<std::string>& parts) {
  parts.clear();
  size_t start = 0;
  while (true) {
    const size_t c = s.find(',', start);
    if (c == std::string::npos) {
      parts.push_back(s.substr(start));
      return;
    }
    parts.push_back(s.substr(start, c - start));
    start = c + 1;
  }
}

// "\1" encodes ',' in channel/marker names per the format spec.
std::string unescape_name(const std::string& s) {
  std::string out;
  out.reserve(s.size());
  for (size_t i = 0; i < s.size(); ++i) {
    if (s[i] == '\\' && i + 1 < s.size() && s[i + 1] == '1') {
      out.push_back(',');
      ++i;
    } else {
      out.push_back(s[i]);
    }
  }
  return out;
}

// Python float(): whitespace-trimmed decimal/scientific with optional
// digit-group underscores; rejects the hex floats and NAN(char-seq)
// forms strtod would accept. Inputs with underscores fall back to the
// Python parser (return false -> caller reports unrepresentable).
bool parse_float_py(const std::string& raw, double* out) {
  const std::string s = trim_ws(raw);
  if (s.empty()) return false;
  for (char c : s)
    if (c == 'x' || c == 'X' || c == '(' || c == '_') return false;
  errno = 0;
  char* end = nullptr;
  const double v = std::strtod(s.c_str(), &end);
  if (end != s.c_str() + s.size() || errno == ERANGE) return false;
  *out = v;
  return true;
}

// Python int(): whitespace-trimmed optional-sign digit run with
// optional single underscores between digits. Three-way result so
// callers can mirror Python exactly: kOk (value parsed), kBad (Python
// int() raises ValueError too), kUnrepresentable (Python would
// succeed but we cannot — int64 overflow — so the whole parse must
// fall back to Python).
enum class IntParse { kOk, kBad, kUnrepresentable };

IntParse parse_int_py(const std::string& raw, int64_t* out) {
  const std::string s = trim_ws(raw);
  size_t p = 0;
  if (p < s.size() && (s[p] == '+' || s[p] == '-')) ++p;
  if (p == s.size()) return IntParse::kBad;
  // grammar: digit (('_')? digit)* — no leading/trailing/double '_'
  std::string digits(s.substr(0, p));
  bool prev_digit = false;
  for (size_t q = p; q < s.size(); ++q) {
    const char c = s[q];
    if (std::isdigit(static_cast<unsigned char>(c))) {
      digits.push_back(c);
      prev_digit = true;
    } else if (c == '_') {
      if (!prev_digit || q + 1 == s.size()) return IntParse::kBad;
      prev_digit = false;
    } else {
      return IntParse::kBad;
    }
  }
  if (!prev_digit) return IntParse::kBad;
  errno = 0;
  char* end = nullptr;
  const long long v = std::strtoll(digits.c_str(), &end, 10);
  if (end != digits.c_str() + digits.size() || errno == ERANGE)
    return IntParse::kUnrepresentable;  // Python ints are unbounded
  *out = v;
  return IntParse::kOk;
}

// Keys like "Ch12" / "Mk3": prefix + all-digits remainder. kBad when
// the key is not of that shape (Python skips it too); kUnrepresentable
// when the number overflows int64 (Python would keep the key).
IntParse numbered_key(const std::string& key, const char* prefix,
                      int64_t* num) {
  const size_t plen = std::strlen(prefix);
  if (key.size() <= plen || key.compare(0, plen, prefix) != 0)
    return IntParse::kBad;
  for (size_t i = plen; i < key.size(); ++i)
    if (!std::isdigit(static_cast<unsigned char>(key[i])))
      return IntParse::kBad;
  return parse_int_py(key.substr(plen), num);
}

bool copy_str(const std::string& s, char* dst, size_t cap) {
  if (s.size() >= cap) return false;
  std::memcpy(dst, s.data(), s.size());
  dst[s.size()] = '\0';
  return true;
}

}  // namespace

extern "C" {

// Struct layouts mirror the ctypes.Structure definitions in
// io/native.py (wide fields first so there is no padding to disagree
// about).
typedef struct {
  double sampling_interval_us;
  int64_t num_channels;
  char data_file[256];
  char marker_file[256];
  char data_format[32];
  char orientation[32];
  char binary_format[32];
} EegHeaderInfo;

typedef struct {
  double resolution;
  int64_t number;
  char name[128];
  char reference[64];
  char units[32];
} EegChannelInfo;

typedef struct {
  int64_t position;
  char name[32];
  char kind[64];
  char stimulus[64];
} EegMarkerInfo;

// Parse a .vhdr header. Returns the number of channels written, or
// -1 if max_channels is too small, or -2 when the input needs the
// Python parser (numeric parse failure / oversized field).
int64_t eeg_parse_vhdr(const char* text, int64_t len, EegHeaderInfo* hdr,
                       EegChannelInfo* channels, int64_t max_channels) {
  std::vector<IniSection> secs;
  parse_ini(text, len, secs);
  const IniSection* common = find_section(secs, "Common Infos");
  const IniSection* binary = find_section(secs, "Binary Infos");
  const IniSection* chan = find_section(secs, "Channel Infos");

  struct ChEntry {
    int64_t number;
    const std::string* value;
  };
  std::vector<ChEntry> entries;
  if (chan) {
    for (const auto& p : chan->kv) {
      int64_t num;
      const IntParse r = numbered_key(p.first, "Ch", &num);
      if (r == IntParse::kUnrepresentable) return -2;
      if (r == IntParse::kOk) entries.push_back(ChEntry{num, &p.second});
    }
  }
  std::stable_sort(entries.begin(), entries.end(),
                   [](const ChEntry& a, const ChEntry& b) {
                     return a.number < b.number;
                   });
  if (static_cast<int64_t>(entries.size()) > max_channels) return -1;

  std::vector<std::string> parts;
  for (size_t k = 0; k < entries.size(); ++k) {
    split_commas(*entries[k].value, parts);
    EegChannelInfo* c = &channels[k];
    c->number = entries[k].number;
    double res = 1.0;
    if (parts.size() > 2 && !parts[2].empty() &&
        !parse_float_py(parts[2], &res))
      return -2;
    c->resolution = res;
    if (!copy_str(unescape_name(parts[0]), c->name, sizeof(c->name)) ||
        !copy_str(parts.size() > 1 ? parts[1] : "", c->reference,
                  sizeof(c->reference)) ||
        !copy_str(parts.size() > 3 ? parts[3] : "uV", c->units,
                  sizeof(c->units)))
      return -2;
  }

  const std::string* v;
  std::string data_file, marker_file;
  std::string data_format = "BINARY", orientation = "MULTIPLEXED";
  std::string binary_format = "INT_16";
  if ((v = find_key(common, "DataFile"))) data_file = *v;
  if ((v = find_key(common, "MarkerFile"))) marker_file = *v;
  if ((v = find_key(common, "DataFormat"))) data_format = *v;
  if ((v = find_key(common, "DataOrientation"))) orientation = *v;
  if ((v = find_key(binary, "BinaryFormat"))) binary_format = *v;

  int64_t num_channels =
      entries.empty() ? 1 : static_cast<int64_t>(entries.size());
  if ((v = find_key(common, "NumberOfChannels")) &&
      parse_int_py(*v, &num_channels) != IntParse::kOk)
    return -2;  // Python raises (kBad) or parses a bigint (kUnrepresentable)

  double interval = 1000.0;
  if ((v = find_key(common, "SamplingInterval")) &&
      !parse_float_py(*v, &interval))
    return -2;

  hdr->sampling_interval_us = interval;
  hdr->num_channels = num_channels;
  if (!copy_str(data_file, hdr->data_file, sizeof(hdr->data_file)) ||
      !copy_str(marker_file, hdr->marker_file, sizeof(hdr->marker_file)) ||
      !copy_str(data_format, hdr->data_format, sizeof(hdr->data_format)) ||
      !copy_str(orientation, hdr->orientation, sizeof(hdr->orientation)) ||
      !copy_str(binary_format, hdr->binary_format,
                sizeof(hdr->binary_format)))
    return -2;
  return static_cast<int64_t>(entries.size());
}

// Parse a .vmrk marker file. Returns the number of markers written,
// -1 if max_markers is too small, -2 when Python must take over.
int64_t eeg_parse_vmrk(const char* text, int64_t len, EegMarkerInfo* out,
                       int64_t max_markers) {
  std::vector<IniSection> secs;
  parse_ini(text, len, secs);
  const IniSection* infos = find_section(secs, "Marker Infos");
  if (!infos) return 0;

  struct MkEntry {
    int64_t number;
    const std::string* key;
    const std::string* value;
  };
  std::vector<MkEntry> entries;
  for (const auto& p : infos->kv) {
    int64_t num;
    const IntParse r = numbered_key(p.first, "Mk", &num);
    if (r == IntParse::kUnrepresentable) return -2;
    if (r == IntParse::kOk)
      entries.push_back(MkEntry{num, &p.first, &p.second});
  }
  std::stable_sort(entries.begin(), entries.end(),
                   [](const MkEntry& a, const MkEntry& b) {
                     return a.number < b.number;
                   });
  if (static_cast<int64_t>(entries.size()) > max_markers) return -1;

  std::vector<std::string> parts;
  for (size_t k = 0; k < entries.size(); ++k) {
    split_commas(*entries[k].value, parts);
    EegMarkerInfo* m = &out[k];
    int64_t pos = 0;
    if (parts.size() > 2) {
      const IntParse r = parse_int_py(parts[2], &pos);
      if (r == IntParse::kUnrepresentable) return -2;
      if (r == IntParse::kBad) pos = 0;  // int() ValueError -> 0
    }
    m->position = pos;
    if (!copy_str(*entries[k].key, m->name, sizeof(m->name)) ||
        !copy_str(parts[0], m->kind, sizeof(m->kind)) ||
        !copy_str(parts.size() > 1 ? unescape_name(parts[1]) : "",
                  m->stimulus, sizeof(m->stimulus)))
      return -2;
  }
  return static_cast<int64_t>(entries.size());
}

// Demux `n_sel` channels out of a multiplexed (n_samples, n_channels)
// int16 block: out[k][s] = (double)((float)raw[s*C + idx[k]] * res[k]).
// `out` is (n_sel, n_samples) row-major float64.
void eeg_demux_int16(const int16_t* raw, int64_t n_samples,
                     int64_t n_channels, const int64_t* sel_indices,
                     int64_t n_sel, const float* resolutions, double* out) {
  for (int64_t k = 0; k < n_sel; ++k) {
    const int64_t ch = sel_indices[k];
    const float res = resolutions[k];
    double* row = out + k * n_samples;
    const int16_t* base = raw + ch;
    for (int64_t s = 0; s < n_samples; ++s) {
      const float v = static_cast<float>(base[s * n_channels]) * res;
      row[s] = static_cast<double>(v);
    }
  }
}

// Same demux for VECTORIZED orientation: raw is (n_channels, n_samples).
void eeg_demux_int16_vectorized(const int16_t* raw, int64_t n_samples,
                                int64_t n_channels,
                                const int64_t* sel_indices, int64_t n_sel,
                                const float* resolutions, double* out) {
  for (int64_t k = 0; k < n_sel; ++k) {
    const int16_t* src = raw + sel_indices[k] * n_samples;
    const float res = resolutions[k];
    double* row = out + k * n_samples;
    for (int64_t s = 0; s < n_samples; ++s) {
      row[s] = static_cast<double>(static_cast<float>(src[s]) * res);
    }
  }
}

// Validity of marker windows [pos-pre, pos+post): a window is kept iff
// pos-pre >= 0 and pos-pre <= n_samples (Java copyOfRange throws only
// on a negative/overshooting *from*; a `to` past the end zero-pads —
// OffLineDataProvider.java:262-264). Returns the number of valid rows.
int64_t eeg_valid_windows(const int64_t* positions, int64_t n_pos,
                          int64_t pre, int64_t n_samples, uint8_t* valid) {
  int64_t n_valid = 0;
  for (int64_t i = 0; i < n_pos; ++i) {
    const int64_t start = positions[i] - pre;
    const bool ok = start >= 0 && start <= n_samples;
    valid[i] = ok ? 1 : 0;
    n_valid += ok ? 1 : 0;
  }
  return n_valid;
}

// Gather + float32 baseline-correct the valid windows.
//   channels: (n_channels, n_samples) float64 (demux output)
//   positions/valid: as produced by eeg_valid_windows
//   out: (n_valid, n_channels, post) float64 — the 750-sample epochs
//        with the pre-stimulus prefix dropped (EpochHolder offset).
void eeg_gather_baseline(const double* channels, int64_t n_channels,
                         int64_t n_samples, const int64_t* positions,
                         const uint8_t* valid, int64_t n_pos, int64_t pre,
                         int64_t post, double* out) {
  const int64_t win = pre + post;
  int64_t row = 0;
  for (int64_t i = 0; i < n_pos; ++i) {
    if (!valid[i]) continue;
    const int64_t start = positions[i] - pre;
    for (int64_t c = 0; c < n_channels; ++c) {
      const double* src = channels + c * n_samples;
      // narrow the window to float32 (DataProviderUtils.toFloatArray)
      float w32[4096];  // win <= 4096 enforced by the binding
      for (int64_t t = 0; t < win; ++t) {
        const int64_t idx = start + t;
        w32[t] = idx < n_samples ? static_cast<float>(src[idx]) : 0.0f;
      }
      // sequential float32 baseline fold (Baseline.java:29-42)
      float sum = 0.0f;
      for (int64_t t = 0; t < pre; ++t) sum += w32[t];
      const float baseline = sum / static_cast<float>(pre);
      double* dst = out + (row * n_channels + c) * post;
      for (int64_t t = 0; t < post; ++t) {
        dst[t] = static_cast<double>(w32[pre + t] - baseline);
      }
    }
    ++row;
  }
}

// The order-dependent class-balance scan
// (OffLineDataProvider.java:248-260). counters[0]=n_targets,
// counters[1]=n_nontargets persist across files of a run.
void eeg_balance_scan(const uint8_t* is_target, int64_t n, int64_t* counters,
                      uint8_t* keep) {
  int64_t n_t = counters[0], n_nt = counters[1];
  for (int64_t i = 0; i < n; ++i) {
    if (is_target[i]) {
      if (n_t <= n_nt) {
        keep[i] = 1;
        ++n_t;
      } else {
        keep[i] = 0;
      }
    } else {
      if (n_t >= n_nt) {
        keep[i] = 1;
        ++n_nt;
      } else {
        keep[i] = 0;
      }
    }
  }
  counters[0] = n_t;
  counters[1] = n_nt;
}

}  // extern "C"
