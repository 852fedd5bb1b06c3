// Native text parser of the data loader, the port's copy of
// pointnet_autoencoder_tpu/csrc/fastio.cpp.
//
// Decodes the .pts (float triples) and .seg (integer labels) text files
// that the reference's dataset reads with np.loadtxt
// (part_dataset.py:110-113). One read() and a branch-light scanner are an
// order of magnitude faster than np.loadtxt, which matters because the
// first epoch decodes every shape on the host.
//
// Plain C ABI, no Python headers: built with g++ by csrc/build.py and
// bound with ctypes in data/fastio.py, which checks the column count of
// a file before either entry point parses it.

#include <cctype>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

namespace {

// Reads a whole file into a string; returns false on failure.
bool slurp(const char* path, std::string* out) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return false;
  std::fseek(f, 0, SEEK_END);
  long size = std::ftell(f);
  if (size < 0) {
    std::fclose(f);
    return false;
  }
  std::fseek(f, 0, SEEK_SET);
  out->resize(static_cast<size_t>(size));
  size_t got = size ? std::fread(&(*out)[0], 1, static_cast<size_t>(size), f) : 0;
  std::fclose(f);
  out->resize(got);
  return true;
}

}  // namespace

extern "C" {

// Number of non-empty lines in the file, or -1 on IO error.
long count_rows(const char* path) {
  std::string buf;
  if (!slurp(path, &buf)) return -1;
  long rows = 0;
  bool line_has_content = false;
  for (char c : buf) {
    if (c == '\n') {
      if (line_has_content) ++rows;
      line_has_content = false;
    } else if (!std::isspace(static_cast<unsigned char>(c))) {
      line_has_content = true;
    }
  }
  if (line_has_content) ++rows;
  return rows;
}

// Parses up to `cap` whitespace-separated floats into `out`.
// Returns the number parsed, or -1 on IO error.
long parse_floats(const char* path, float* out, long cap) {
  std::string buf;
  if (!slurp(path, &buf)) return -1;
  const char* p = buf.c_str();
  const char* end = p + buf.size();
  long n = 0;
  while (p < end && n < cap) {
    while (p < end && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (p >= end) break;
    char* next = nullptr;
    float v = std::strtof(p, &next);
    if (next == p) {  // unparseable token: skip it
      while (p < end && !std::isspace(static_cast<unsigned char>(*p))) ++p;
      continue;
    }
    out[n++] = v;
    p = next;
  }
  return n;
}

// Parses up to `cap` whitespace-separated integers (accepts float syntax,
// truncating) into `out`. Returns the number parsed, or -1 on IO error.
long parse_ints(const char* path, int* out, long cap) {
  std::string buf;
  if (!slurp(path, &buf)) return -1;
  const char* p = buf.c_str();
  const char* end = p + buf.size();
  long n = 0;
  while (p < end && n < cap) {
    while (p < end && std::isspace(static_cast<unsigned char>(*p))) ++p;
    if (p >= end) break;
    char* next = nullptr;
    double v = std::strtod(p, &next);
    if (next == p) {
      while (p < end && !std::isspace(static_cast<unsigned char>(*p))) ++p;
      continue;
    }
    out[n++] = static_cast<int>(v);
    p = next;
  }
  return n;
}

}  // extern "C"
