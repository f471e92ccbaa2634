// tpul2_torch native core: the per-(M, N, K, acc, dtype) tuning cache.
//
// Counterpart of tpul2/native/tunecache.cc, with its structure: an open-addressing hash
// table (FNV-1a, linear probing, grown at 70% load), put/get/size/save/load through a
// plain C interface that tpul2_torch/native/build.py loads with ctypes, and a standalone
// self-test main() compiled out of the library by -DNO_TL2_BIN.  Host code only: built
// with g++, no CUDA.
//
// Role: a standalone cache.  Dispatch does not read it: TuneDB answers resolve_config's
// exact-key lookups from its JSON entries, and a native lookup measured slower than that
// on the card's host (PERF.md).
//
// What differs from the JAX file: the packed config is tpul2_torch.config.KernelConfig
// (tile, bk, acc, raster, stage depth, vendor/layout/edge flags, vendor variant id); the
// TPU's vmem limit and XLA variant bits have no Hopper meaning.  The file header carries
// the vendor table's CRC, so a file is never read against another id table.  The JAX
// file's heuristic mirror is not kept: only the Python heuristic_config is ever called.

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>

#include "tl2_native_constants.h"  // GENERATED from tpul2_torch/ops/baselines.py

extern "C" {

// Packed tpul2_torch.config.KernelConfig.
struct TL2Config {
  int32_t bm, bn, bk;
  int32_t acc;             // 0 = float32, 1 = bfloat16
  int32_t grid_order;      // 0 = mn, 1 = nm
  int32_t pipeline_depth;  // 0, or the staged ring's depth
  int32_t flags;           // bit0: use_vendor; bit1: rhs_layout 'nk'; bit2: edge 'mask'
  int32_t vendor_variant;  // id into kTl2VendorVariants
  float tflops;            // measured at tuning time
};

struct TL2Key {
  int32_t m, n, k;
  int32_t acc;    // accumulator family, as TL2Config.acc
  int32_t dtype;  // input dtype id (0 = bfloat16, 1 = float32, 2 = float16)
};

}  // extern "C"

namespace {

struct Slot {
  TL2Key key;
  TL2Config cfg;
  uint8_t used;
};

struct Cache {
  Slot* slots;
  uint64_t capacity;  // a power of two
  uint64_t size;
};

uint64_t hash_key(const TL2Key& k) {
  // FNV-1a over the key bytes.
  const uint8_t* p = reinterpret_cast<const uint8_t*>(&k);
  uint64_t h = 1469598103934665603ULL;
  for (size_t i = 0; i < sizeof(TL2Key); ++i) {
    h ^= p[i];
    h *= 1099511628211ULL;
  }
  return h;
}

bool key_eq(const TL2Key& a, const TL2Key& b) {
  return std::memcmp(&a, &b, sizeof(TL2Key)) == 0;
}

void rehash(Cache* c, uint64_t new_cap);

void insert(Cache* c, const TL2Key& key, const TL2Config& cfg) {
  if ((c->size + 1) * 10 >= c->capacity * 7) rehash(c, c->capacity * 2);
  uint64_t mask = c->capacity - 1;
  uint64_t i = hash_key(key) & mask;
  while (c->slots[i].used && !key_eq(c->slots[i].key, key)) i = (i + 1) & mask;
  if (!c->slots[i].used) {
    c->slots[i].used = 1;
    c->slots[i].key = key;
    c->size++;
  }
  c->slots[i].cfg = cfg;
}

void rehash(Cache* c, uint64_t new_cap) {
  Slot* old = c->slots;
  uint64_t old_cap = c->capacity;
  c->slots = static_cast<Slot*>(std::calloc(new_cap, sizeof(Slot)));
  c->capacity = new_cap;
  c->size = 0;
  for (uint64_t i = 0; i < old_cap; ++i) {
    if (old[i].used) insert(c, old[i].key, old[i].cfg);
  }
  std::free(old);
}

bool config_ok(const TL2Config& cfg) {
  return cfg.vendor_variant >= 0 && cfg.vendor_variant < kTl2VendorVariantCount &&
         (cfg.acc == 0 || cfg.acc == 1) && (cfg.grid_order == 0 || cfg.grid_order == 1) &&
         (cfg.flags & ~7) == 0;
}

constexpr uint32_t kMagic = 0x48324C54;  // "TL2H"
constexpr uint32_t kVersion = 1;         // the layout of TL2Key and TL2Config above

struct FileHeader {
  uint32_t magic, version, vendor_crc, count;
};

}  // namespace

extern "C" {

void* tl2_cache_new(void) {
  Cache* c = static_cast<Cache*>(std::malloc(sizeof(Cache)));
  c->capacity = 1024;
  c->size = 0;
  c->slots = static_cast<Slot*>(std::calloc(c->capacity, sizeof(Slot)));
  return c;
}

void tl2_cache_free(void* h) {
  if (!h) return;
  Cache* c = static_cast<Cache*>(h);
  std::free(c->slots);
  std::free(c);
}

uint64_t tl2_cache_size(void* h) { return static_cast<Cache*>(h)->size; }

// Returns 0, or -1 (nothing stored) for a config whose ids or flags are out of range.
int32_t tl2_cache_put(void* h, const TL2Key* key, const TL2Config* cfg) {
  if (!config_ok(*cfg)) return -1;
  insert(static_cast<Cache*>(h), *key, *cfg);
  return 0;
}

// Returns 1 and fills *out on a hit, 0 on a miss.
int32_t tl2_cache_get(void* h, const TL2Key* key, TL2Config* out) {
  Cache* c = static_cast<Cache*>(h);
  uint64_t mask = c->capacity - 1;
  uint64_t i = hash_key(*key) & mask;
  while (c->slots[i].used) {
    if (key_eq(c->slots[i].key, *key)) {
      *out = c->slots[i].cfg;
      return 1;
    }
    i = (i + 1) & mask;
  }
  return 0;
}

// Binary persistence: FileHeader, then count (key, config) pairs.  Returns 0, -1 (cannot
// open) or -2 (write failed).
int32_t tl2_cache_save(void* h, const char* path) {
  Cache* c = static_cast<Cache*>(h);
  FILE* f = std::fopen(path, "wb");
  if (!f) return -1;
  FileHeader hdr{kMagic, kVersion, kTl2VendorTableCrc, static_cast<uint32_t>(c->size)};
  bool ok = std::fwrite(&hdr, sizeof(hdr), 1, f) == 1;
  for (uint64_t i = 0; ok && i < c->capacity; ++i) {
    if (!c->slots[i].used) continue;
    ok = std::fwrite(&c->slots[i].key, sizeof(TL2Key), 1, f) == 1 &&
         std::fwrite(&c->slots[i].cfg, sizeof(TL2Config), 1, f) == 1;
  }
  ok = (std::fclose(f) == 0) && ok;
  return ok ? 0 : -2;
}

// Adds the file's entries.  Returns 0, -1 (cannot open), -2 (another magic or layout
// version, or truncated), -3 (written against another vendor id table) or -4 (an entry
// out of range).  Entries read before a failure stay in the cache.
int32_t tl2_cache_load(void* h, const char* path) {
  FILE* f = std::fopen(path, "rb");
  if (!f) return -1;
  FileHeader hdr;
  int32_t rc = 0;
  if (std::fread(&hdr, sizeof(hdr), 1, f) != 1 || hdr.magic != kMagic ||
      hdr.version != kVersion) {
    rc = -2;
  } else if (hdr.vendor_crc != kTl2VendorTableCrc) {
    rc = -3;
  }
  for (uint32_t i = 0; rc == 0 && i < hdr.count; ++i) {
    TL2Key key;
    TL2Config cfg;
    if (std::fread(&key, sizeof(key), 1, f) != 1 || std::fread(&cfg, sizeof(cfg), 1, f) != 1)
      rc = -2;
    else if (tl2_cache_put(h, &key, &cfg) != 0)
      rc = -4;
  }
  std::fclose(f);
  return rc;
}

// The name of vendor variant `id`, or null (the header's table, for the self-test and
// the Python side's check that both read one table).
const char* tl2_vendor_variant(int32_t id) {
  return (id >= 0 && id < kTl2VendorVariantCount) ? kTl2VendorVariants[id] : nullptr;
}

}  // extern "C"

#ifndef NO_TL2_BIN
// Standalone self-test and lookup micro-benchmark (compiled out of the library by
// -DNO_TL2_BIN, like the reference's gated mains).  Usage: tunecache_selftest [FILE]
// (FILE: the persistence round trip's scratch file, tl2_cache_selftest.bin by default).
#include <chrono>

int main(int argc, char** argv) {
  const char* path = argc > 1 ? argv[1] : "tl2_cache_selftest.bin";
  void* c = tl2_cache_new();
  const int32_t dims[] = {64, 128, 256, 512, 1024, 2048, 4096, 8192, 16384};
  int count = 0, errors = 0;
  for (int32_t m : dims)
    for (int32_t n : dims)
      for (int32_t k : dims) {
        TL2Key key{m, n, k, 0, 0};
        TL2Config cfg{m < 128 ? m : 128, n < 128 ? n : 128, k < 1024 ? k : 1024, 0, 0, 0, 0,
                      count % kTl2VendorVariantCount, static_cast<float>(count)};
        if (tl2_cache_put(c, &key, &cfg) != 0) ++errors;
        ++count;
      }
  std::printf("inserted %d entries, cache size %llu\n", count,
              static_cast<unsigned long long>(tl2_cache_size(c)));
  int i = 0;
  for (int32_t m : dims)
    for (int32_t n : dims)
      for (int32_t k : dims) {
        TL2Key key{m, n, k, 0, 0};
        TL2Config cfg;
        if (!tl2_cache_get(c, &key, &cfg) || cfg.tflops != static_cast<float>(i) ||
            cfg.vendor_variant != i % kTl2VendorVariantCount)
          ++errors;
        ++i;
      }
  TL2Key absent{3, 5, 7, 0, 0};
  TL2Config tmp;
  if (tl2_cache_get(c, &absent, &tmp)) ++errors;
  TL2Config bad{};
  bad.vendor_variant = kTl2VendorVariantCount;
  if (tl2_cache_put(c, &absent, &bad) == 0) ++errors;
  std::printf("lookup errors: %d\n", errors);
  for (int32_t id = 0; id < kTl2VendorVariantCount; ++id)
    std::printf("vendor variant %d: %s\n", id, tl2_vendor_variant(id));

  auto t0 = std::chrono::steady_clock::now();
  int64_t hits = 0;
  for (int rep = 0; rep < 1000; ++rep)
    for (int32_t m : dims)
      for (int32_t n : dims) {
        TL2Key key{m, n, 4096, 0, 0};
        TL2Config cfg;
        hits += tl2_cache_get(c, &key, &cfg);
      }
  double dt = std::chrono::duration<double>(std::chrono::steady_clock::now() - t0).count();
  std::printf("lookups/s: %.0f (hits %lld)\n", 81000.0 / dt, static_cast<long long>(hits));

  if (tl2_cache_save(c, path) != 0) return 1;
  void* c2 = tl2_cache_new();
  if (tl2_cache_load(c2, path) != 0) return 1;
  std::printf("reloaded size %llu\n", static_cast<unsigned long long>(tl2_cache_size(c2)));
  bool ok = tl2_cache_size(c2) == tl2_cache_size(c) && errors == 0;
  // a file of another layout version is refused
  FILE* f = std::fopen(path, "r+b");
  uint32_t foreign[2] = {kMagic, kVersion + 1};
  ok = ok && f && std::fwrite(foreign, sizeof(foreign), 1, f) == 1;
  if (f) std::fclose(f);
  void* c3 = tl2_cache_new();
  ok = ok && tl2_cache_load(c3, path) == -2 && tl2_cache_size(c3) == 0;
  std::remove(path);
  tl2_cache_free(c);
  tl2_cache_free(c2);
  tl2_cache_free(c3);
  std::printf(ok ? "PASS\n" : "FAIL\n");
  return ok ? 0 : 1;
}
#endif  // NO_TL2_BIN
