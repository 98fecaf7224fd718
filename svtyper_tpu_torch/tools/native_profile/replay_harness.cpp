// Replay one captured svt_fetch_chunk call in a loop for gprof.
// Build: g++ -O2 -pg -std=c++17 replay_harness.cpp bamcore.cpp -o replay -lz -ldeflate -pthread
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <cstdint>
#include <string>
#include <vector>
#include <fstream>

extern "C" {
void* svt_open(const char*);
void svt_set_names(void*, const char**, int32_t, const char**, int32_t);
const char* svt_error(void*);
long svt_fetch_chunk(void*, int64_t, int64_t*, int64_t*, int64_t*, int64_t*,
                     uint64_t*, uint64_t*, int32_t*, int32_t, uint8_t*,
                     int32_t*, int32_t, int64_t*, int64_t*, int64_t*,
                     int64_t*, int32_t, int64_t, int32_t, int32_t*, uint8_t*,
                     int64_t, int64_t*, int64_t*, uint8_t*, int64_t*,
                     int64_t*);
}

template <class T>
std::vector<T> load(const char* name) {
  std::string p = std::string("/tmp/chunkbin/") + name + ".bin";
  std::ifstream f(p, std::ios::binary | std::ios::ate);
  if (!f) { fprintf(stderr, "missing %s\n", p.c_str()); exit(1); }
  size_t n = f.tellg();
  f.seekg(0);
  std::vector<T> v(n / sizeof(T));
  f.read((char*)v.data(), n);
  return v;
}

int main(int argc, char** argv) {
  int iters = argc > 2 ? atoi(argv[2]) : 30;
  int threads = argc > 3 ? atoi(argv[3]) : 1;
  void* h = svt_open(argv[1]);
  if (!h) { fprintf(stderr, "open failed\n"); return 1; }
  // names
  std::ifstream nf("/tmp/chunk_names.txt");
  std::vector<std::string> refs, rgs;
  std::string line; bool in_rg = false;
  while (std::getline(nf, line)) {
    if (line == "--") { in_rg = true; continue; }
    (in_rg ? rgs : refs).push_back(line);
  }
  std::vector<const char*> refp, rgp;
  for (auto& s : refs) refp.push_back(s.c_str());
  for (auto& s : rgs) rgp.push_back(s.c_str());
  svt_set_names(h, refp.data(), refp.size(), rgp.data(), rgp.size());

  auto rt = load<int64_t>("rt"); auto rs = load<int64_t>("rs");
  auto re_ = load<int64_t>("re_"); auto ro = load<int64_t>("ro");
  auto rb = load<uint64_t>("rb"); auto rn = load<uint64_t>("rn");
  auto vq = load<int32_t>("vq");
  auto n_var = load<int64_t>("n_var")[0];
  auto min_aligned = (int32_t)load<int64_t>("min_aligned")[0];
  auto drop_flags = (int32_t)load<int64_t>("drop_flags")[0];
  auto rg_keep = load<uint8_t>("rg_keep");
  auto rg_to_lib = load<int32_t>("rg_to_lib");
  auto cta = load<int64_t>("cov_tid_a"); auto cpa = load<int64_t>("cov_pos_a");
  auto ctb = load<int64_t>("cov_tid_b"); auto cpb = load<int64_t>("cov_pos_b");
  auto v_i32 = load<int32_t>("v_i32"); auto v_u8 = load<uint8_t>("v_u8");
  int64_t vp_stride = v_i32.size() / 9;

  std::vector<uint8_t> var_over(n_var);
  std::vector<int64_t> var_rows(n_var);
  int64_t n_cand = 0, n_pair = 0, nscan = 0;
  long total = 0;
  for (int i = 0; i < iters; ++i) {
    long rc = svt_fetch_chunk(
        h, (int64_t)rt.size(), rt.data(), rs.data(), re_.data(), ro.data(),
        rb.data(), rn.data(), vq.data(), drop_flags, rg_keep.data(),
        rg_to_lib.data(), (int32_t)rg_to_lib.size() - 1, cta.data(),
        cpa.data(), ctb.data(), cpb.data(), min_aligned, -1, threads,
        v_i32.data(), v_u8.data(), vp_stride, &n_cand, &n_pair,
        var_over.data(), var_rows.data(), &nscan);
    if (rc == -1) { fprintf(stderr, "err: %s\n", svt_error(h)); return 1; }
    total += n_cand;
  }
  printf("iters=%d cand=%lld pairs=%lld total=%ld\n", iters,
         (long long)n_cand, (long long)n_pair, total);
  return 0;
}
