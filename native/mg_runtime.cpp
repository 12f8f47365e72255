// mg_runtime — native runtime components for multigrid_poisson.
//
// The reference keeps its whole runtime in C++: the Cycle.txt parser inlined
// in main() (/root/reference/src/MG_solver_CPU.cpp:70-146 with per-node
// option reads at :171-189, :307, :331-344), the linked-list level stack
// (linkedlist.cpp), and the CSV writer (doPrint2File, MG_solver_CPU.cpp:735-754).
// In this framework the *compute* path is JAX/XLA, but the runtime
// around it stays native: this library provides
//
//   * mg_parse_cycle  — the complete Cycle.txt grammar → a flat, typed
//     instruction buffer (the schedule "graph builder"). Semantics are
//     identical to the Python parser (schedule.parse_cycle_file), including
//     the con_step × con_N option matrix, level-size generation for con_N
//     ∈ {1: halve, 2: decrement}, and static validation the reference lacks.
//   * mg_write_csv / mg_read_csv — Sol_* file I/O byte-compatible with the
//     reference dumps, multithreaded formatting for large grids (an 8193²
//     dump is ~0.5 GB of text; Python's per-value formatting takes minutes).
//
// Exposed through a plain C ABI for ctypes (no pybind11 in this toolchain).
//
// Build: make -C native   (g++ -O3 -shared -fPIC, pthread)

#include <cctype>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

extern "C" {

// ---------------------------------------------------------------------------
// Cycle.txt parser
// ---------------------------------------------------------------------------

// Instruction kinds (match schedule.py node semantics, README.md:93-101).
enum MgKind : int32_t {
  MG_DESCEND = -1,  // smooth + restrict; steps: >0 fixed, -1 trigger, 0 FMG
  MG_COARSE = 0,    // exact solve (target_error, option)
  MG_ASCEND = 1,    // prolongate + add + smooth
};

struct MgHeader {
  double length;
  double min_x;
  double min_y;
  int32_t con_step;
  int32_t con_n;
  int32_t n_max;
  int32_t n_min;
};

struct MgInstruction {
  int32_t kind;         // MgKind
  int32_t steps;        // Descend/Ascend
  int32_t next_n;       // Descend
  int32_t option;       // CoarseSolve
  double target_error;  // CoarseSolve
};

namespace {

struct Tokens {
  const char* p;
  const char* end;

  bool next(std::string* out) {
    while (p < end && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (p >= end) return false;
    const char* start = p;
    while (p < end && !std::isspace(static_cast<unsigned char>(*p))) ++p;
    out->assign(start, p - start);
    return true;
  }
};

bool to_int(const std::string& s, int32_t* v) {
  try {
    size_t pos;
    long r = std::stol(s, &pos);
    if (pos != s.size()) return false;
    *v = static_cast<int32_t>(r);
    return true;
  } catch (...) {
    return false;
  }
}

bool to_double(const std::string& s, double* v) {
  try {
    size_t pos;
    *v = std::stod(s, &pos);
    return pos == s.size();
  } catch (...) {
    return false;
  }
}

int fail(char* errbuf, int errlen, const char* msg) {
  if (errbuf && errlen > 0) std::snprintf(errbuf, errlen, "%s", msg);
  return -1;
}

// Level-size table for con_N rules (grid.level_sizes; the reference's
// N_array pre-generation, MG_solver_CPU.cpp:111-146).
std::vector<int32_t> level_sizes(int32_t n_max, int32_t n_min, int32_t rule) {
  std::vector<int32_t> out;
  if (rule == 1) {
    for (int32_t n = n_max; n >= n_min; n /= 2) out.push_back(n);
  } else if (rule == 2) {
    for (int32_t n = n_max; n >= n_min; --n) out.push_back(n);
  } else if (rule == 3) {
    // odd-halve extension (grid.level_sizes rule 3): N -> (N+1)/2, keeps
    // 2^k+1 hierarchies exactly 2:1 vertex-aligned
    for (int32_t n = n_max; n >= n_min;) {
      out.push_back(n);
      if (n <= 2) break;
      n = (n + 1) / 2;
    }
  }
  return out;
}

}  // namespace

// Parse a Cycle.txt text into (header, instructions).
// Returns the number of instructions, or -1 on error (message in errbuf).
int32_t mg_parse_cycle(const char* text, int64_t text_len, MgHeader* hdr,
                       MgInstruction* ins, int32_t max_ins, char* errbuf,
                       int32_t errlen) {
  Tokens tok{text, text + text_len};
  std::string t;

#define NEXT_OR(what)                                            \
  if (!tok.next(&t)) return fail(errbuf, errlen, "cycle file ended while reading " what);

  NEXT_OR("L");
  if (!to_double(t, &hdr->length)) return fail(errbuf, errlen, "bad L");
  NEXT_OR("min_x");
  if (!to_double(t, &hdr->min_x)) return fail(errbuf, errlen, "bad min_x");
  NEXT_OR("min_y");
  if (!to_double(t, &hdr->min_y)) return fail(errbuf, errlen, "bad min_y");
  NEXT_OR("con_step");
  if (!to_int(t, &hdr->con_step)) return fail(errbuf, errlen, "bad con_step");
  NEXT_OR("con_N");
  if (!to_int(t, &hdr->con_n)) return fail(errbuf, errlen, "bad con_N");
  NEXT_OR("N_max");
  if (!to_int(t, &hdr->n_max)) return fail(errbuf, errlen, "bad N_max");
  NEXT_OR("N_min");
  if (!to_int(t, &hdr->n_min)) return fail(errbuf, errlen, "bad N_min");

  std::vector<int32_t> n_array;
  if (hdr->con_n >= 1 && hdr->con_n <= 3) {
    n_array = level_sizes(hdr->n_max, hdr->n_min, hdr->con_n);
  } else if (hdr->con_n != 0) {
    return fail(errbuf, errlen, "unknown con_N; expected 0, 1, 2, or 3");
  }
  int32_t level = 0;  // the reference's len_flag

  int32_t count = 0;
  // depth/size tracking = CycleProgram.validate()
  std::vector<int32_t> stack{hdr->n_max};

  while (tok.next(&t)) {
    int32_t node;
    if (!to_int(t, &node)) return fail(errbuf, errlen, "bad node token");
    if (node == 2) break;
    if (count >= max_ins) return fail(errbuf, errlen, "instruction buffer too small");
    MgInstruction& out = ins[count];

    if (node == -1) {
      out.kind = MG_DESCEND;
      if (hdr->con_step == 0) {
        NEXT_OR("step");
        if (!to_int(t, &out.steps)) return fail(errbuf, errlen, "bad step");
      } else {
        out.steps = hdr->con_step;
      }
      if (hdr->con_n == 0) {
        NEXT_OR("next_N");
        if (!to_int(t, &out.next_n)) return fail(errbuf, errlen, "bad next_N");
      } else {
        ++level;
        if (level >= static_cast<int32_t>(n_array.size()))
          return fail(errbuf, errlen,
                      "schedule descends below the coarsest generated level");
        out.next_n = n_array[level];
      }
      if (out.next_n < 3)
        return fail(errbuf, errlen, "next_N below minimum grid 3");
      if (out.next_n >= stack.back())
        return fail(errbuf, errlen, "next_N does not coarsen current level");
      stack.push_back(out.next_n);
      out.option = 0;
      out.target_error = 0.0;
    } else if (node == 0) {
      out.kind = MG_COARSE;
      NEXT_OR("target_error");
      if (!to_double(t, &out.target_error))
        return fail(errbuf, errlen, "bad target_error");
      NEXT_OR("option");
      if (!to_int(t, &out.option)) return fail(errbuf, errlen, "bad option");
      out.steps = 0;
      out.next_n = 0;
    } else if (node == 1) {
      out.kind = MG_ASCEND;
      if (hdr->con_step == 0) {
        NEXT_OR("step");
        if (!to_int(t, &out.steps)) return fail(errbuf, errlen, "bad step");
      } else {
        out.steps = hdr->con_step;
      }
      if (hdr->con_n != 0) --level;
      if (stack.size() <= 1)
        return fail(errbuf, errlen, "Ascend with no coarser level on the stack");
      stack.pop_back();
      out.next_n = 0;
      out.option = 0;
      out.target_error = 0.0;
    } else {
      return fail(errbuf, errlen, "unknown node; expected -1, 0, 1, or 2");
    }
    ++count;
  }
#undef NEXT_OR
  return count;
}

// ---------------------------------------------------------------------------
// Sol_* CSV I/O (doPrint2File-compatible, MG_solver_CPU.cpp:735-754)
// ---------------------------------------------------------------------------

namespace {

// Format one row of doubles as "v,v,...,v\n" with fixed decimals.
void format_row(const double* row, int64_t n, int decimals, std::string* out) {
  char buf[64];
  out->clear();
  for (int64_t i = 0; i < n; ++i) {
    int len = std::snprintf(buf, sizeof(buf), "%.*f", decimals, row[i]);
    if (i) out->push_back(',');
    out->append(buf, len);
  }
  out->push_back('\n');
}

}  // namespace

// Write an (n_rows, n_cols) row-major double array as CSV. Rows are written
// in the given order (the caller pre-flips for the reference's top-to-bottom
// y order). Multithreaded formatting, sequential write. Returns 0 on success.
int32_t mg_write_csv(const double* data, int64_t n_rows, int64_t n_cols,
                     const char* path, int32_t decimals) {
  std::FILE* fp = std::fopen(path, "w");
  if (!fp) return -1;

  const int hw = static_cast<int>(std::thread::hardware_concurrency());
  const int n_threads = std::max(1, std::min<int>(hw ? hw : 4, 16));
  const int64_t chunk = 64;  // rows per work item

  std::vector<std::string> formatted(static_cast<size_t>(n_rows));
  std::vector<std::thread> workers;
  std::vector<int64_t> next_chunk{0};
  // simple static partition: thread t takes chunks t, t+T, t+2T, ...
  auto work = [&](int tid) {
    std::string tmp;
    for (int64_t c = tid; c * chunk < n_rows; c += n_threads) {
      int64_t lo = c * chunk;
      int64_t hi = std::min(n_rows, lo + chunk);
      for (int64_t r = lo; r < hi; ++r) {
        format_row(data + r * n_cols, n_cols, decimals, &tmp);
        formatted[static_cast<size_t>(r)].swap(tmp);
      }
    }
  };
  for (int t = 0; t < n_threads; ++t) workers.emplace_back(work, t);
  for (auto& w : workers) w.join();

  int32_t rc = 0;
  for (int64_t r = 0; r < n_rows && rc == 0; ++r) {
    const std::string& s = formatted[static_cast<size_t>(r)];
    if (std::fwrite(s.data(), 1, s.size(), fp) != s.size()) rc = -2;
  }
  if (std::fclose(fp) != 0 && rc == 0) rc = -3;
  return rc;
}

// Read a CSV of doubles into a preallocated (n_rows, n_cols) row-major
// buffer. Returns 0 on success, negative on error/shape mismatch.
int32_t mg_read_csv(const char* path, double* out, int64_t n_rows,
                    int64_t n_cols) {
  std::FILE* fp = std::fopen(path, "r");
  if (!fp) return -1;
  std::fseek(fp, 0, SEEK_END);
  long size = std::ftell(fp);
  std::fseek(fp, 0, SEEK_SET);
  std::string text(static_cast<size_t>(size), '\0');
  if (std::fread(text.data(), 1, text.size(), fp) != text.size()) {
    std::fclose(fp);
    return -2;
  }
  std::fclose(fp);

  const char* p = text.data();
  const char* end = p + text.size();
  for (int64_t r = 0; r < n_rows; ++r) {
    for (int64_t c = 0; c < n_cols; ++c) {
      while (p < end && (*p == ',' || *p == '\n' || *p == '\r' || *p == ' '))
        ++p;
      if (p >= end) return -3;
      char* next = nullptr;
      out[r * n_cols + c] = std::strtod(p, &next);
      if (next == p) return -4;
      p = next;
    }
  }
  return 0;
}

// Library version tag for the ctypes loader's compatibility check.
int32_t mg_runtime_abi_version() { return 1; }

}  // extern "C"
