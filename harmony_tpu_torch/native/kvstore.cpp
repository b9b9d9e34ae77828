// Native chain storage: a log-structured key/value store with the SAME
// on-disk format as harmony_tpu/core/kv.py FileKV — the two open each
// other's files.  This is the node's IO hot path done in native code
// (the role LevelDB's C++ plays under the reference's core/rawdb);
// Python binds via ctypes (harmony_tpu/core/kv_native.py), a Go node
// would bind via cgo exactly as the reference binds its storage.
//
// Record format (little-endian):
//   [klen u32][vlen u32 | 0xFFFFFFFF = tombstone][key][value]
//
// Atomic commit batches (same grammar as the Python twin): records
// bracketed by BEGIN = [0xFFFFFFFE][count] and COMMIT = [0xFFFFFFFD]
// [count] markers; replay applies a batch only when its COMMIT marker
// (with the matching count) is on disk — a crash anywhere inside the
// batch makes the whole batch invisible on reopen.
//
// C ABI: every function is kv_*; buffers returned by kv_get are owned
// by the store and valid until the next call on the same handle
// (single-threaded per handle, like the Python twin).

#include <cstdint>
#include <cstdio>
#include <cstring>
#include <string>
#include <unordered_map>
#include <vector>

#include <sys/types.h>
#include <unistd.h>

namespace {

constexpr uint32_t kTomb = 0xFFFFFFFFu;
constexpr uint32_t kBatchBegin = 0xFFFFFFFEu;
constexpr uint32_t kBatchCommit = 0xFFFFFFFDu;
constexpr uint32_t kKlenMax = 0xFFFFFFF0u;  // larger = corrupt header

struct Store {
  std::FILE* f = nullptr;
  std::string path;
  std::unordered_map<std::string, std::pair<uint64_t, uint32_t>> index;
  std::vector<uint8_t> last_value;  // buffer handed to callers
  int fsync_batch = 0;  // kv_config: fsync on every batch commit

  ~Store() {
    if (f) std::fclose(f);
  }
};

bool read_exact(std::FILE* f, void* buf, size_t n) {
  return std::fread(buf, 1, n, f) == n;
}

uint32_t load_u32(const uint8_t* p) {
  return static_cast<uint32_t>(p[0]) | (static_cast<uint32_t>(p[1]) << 8) |
         (static_cast<uint32_t>(p[2]) << 16) |
         (static_cast<uint32_t>(p[3]) << 24);
}

void store_u32(uint8_t* p, uint32_t v) {
  p[0] = v & 0xff;
  p[1] = (v >> 8) & 0xff;
  p[2] = (v >> 16) & 0xff;
  p[3] = (v >> 24) & 0xff;
}

// Replay the log into the index; truncate a torn tail record.  Every
// length field is bounds-checked against the REAL file size before any
// allocation or index insert: fseek happily passes EOF and POSIX
// truncate EXTENDS, so trusting lengths would turn a crash-torn value
// into silent zero-filled reads — and a corrupt klen into a
// multi-gigabyte allocation aborting the process through the C ABI.
bool replay(Store* s) {
  std::fseek(s->f, 0, SEEK_END);
  const uint64_t file_size = static_cast<uint64_t>(std::ftell(s->f));
  std::fseek(s->f, 0, SEEK_SET);
  uint64_t pos = 0;
  bool in_batch = false;
  uint64_t batch_start = 0;   // offset of the open batch's BEGIN marker
  uint32_t batch_count = 0;
  // records staged inside the open batch: (key, voff, vlen);
  // voff == UINT64_MAX marks a tombstone
  std::vector<std::tuple<std::string, uint64_t, uint32_t>> pending;
  std::vector<char> keybuf;
  for (;;) {
    pos = static_cast<uint64_t>(std::ftell(s->f));
    uint8_t hdr[8];
    if (!read_exact(s->f, hdr, 8)) break;
    const uint32_t klen = load_u32(hdr);
    const uint32_t vlen = load_u32(hdr + 4);
    if (klen == kBatchBegin) {
      if (in_batch) break;  // nested BEGIN: corrupt
      in_batch = true;
      batch_start = pos;
      batch_count = vlen;
      pending.clear();
      continue;
    }
    if (klen == kBatchCommit) {
      if (!in_batch || vlen != pending.size() ||
          batch_count != pending.size()) {
        break;  // marker without its batch, or count mismatch
      }
      for (auto& [key, voff, vl] : pending) {
        if (voff == UINT64_MAX) {
          s->index.erase(key);
        } else {
          s->index[std::move(key)] = {voff, vl};
        }
      }
      in_batch = false;
      pending.clear();
      continue;
    }
    if (klen >= kKlenMax) break;  // implausible key length
    if (pos + 8 + klen > file_size) break;  // torn/corrupt key length
    keybuf.resize(klen);
    if (klen && !read_exact(s->f, keybuf.data(), klen)) break;
    std::string key(keybuf.data(), klen);
    if (vlen == kTomb) {
      if (in_batch) {
        pending.emplace_back(std::move(key), UINT64_MAX, 0);
      } else {
        s->index.erase(key);
      }
      continue;
    }
    const uint64_t voff = static_cast<uint64_t>(std::ftell(s->f));
    if (voff + vlen > file_size) break;  // torn value
    std::fseek(s->f, static_cast<long>(vlen), SEEK_CUR);
    if (in_batch) {
      pending.emplace_back(std::move(key), voff, vlen);
    } else {
      s->index[std::move(key)] = {voff, vlen};
    }
  }
  // drop everything from the failure point — from the BEGIN marker if
  // the failure is inside an open batch (the un-committed batch must
  // be invisible to appends too); never grows the file
  const uint64_t cut = in_batch ? batch_start : pos;
  std::fflush(s->f);
  if (cut < file_size &&
      truncate(s->path.c_str(), static_cast<off_t>(cut)) != 0) {
    // non-fatal: reads still consistent, appends go after the tear
  }
  std::freopen(s->path.c_str(), "r+b", s->f);
  std::fseek(s->f, 0, SEEK_END);
  return true;
}

bool append_record(Store* s, const uint8_t* key, uint32_t klen,
                   const uint8_t* val, uint32_t vlen, bool tomb) {
  std::fseek(s->f, 0, SEEK_END);
  uint8_t hdr[8];
  store_u32(hdr, klen);
  store_u32(hdr + 4, tomb ? kTomb : vlen);
  if (std::fwrite(hdr, 1, 8, s->f) != 8) return false;
  if (klen && std::fwrite(key, 1, klen, s->f) != klen) return false;
  const uint64_t voff = static_cast<uint64_t>(std::ftell(s->f));
  if (!tomb && vlen && std::fwrite(val, 1, vlen, s->f) != vlen) {
    return false;
  }
  std::string k(reinterpret_cast<const char*>(key), klen);
  if (tomb) {
    s->index.erase(k);
  } else {
    s->index[std::move(k)] = {voff, vlen};
  }
  return true;
}

}  // namespace

extern "C" {

void* kv_open(const char* path) {
  // no C++ exception may cross the C ABI: a corrupt file must yield
  // nullptr (the Python side falls back), never std::terminate
  try {
    auto* s = new Store();
    s->path = path;
    s->f = std::fopen(path, "r+b");
    if (s->f == nullptr) {
      s->f = std::fopen(path, "w+b");
      if (s->f == nullptr) {
        delete s;
        return nullptr;
      }
    }
    replay(s);
    return s;
  } catch (...) {
    return nullptr;
  }
}

int kv_put(void* h, const uint8_t* key, uint32_t klen, const uint8_t* val,
           uint32_t vlen) {
  if (vlen == kTomb) return -1;
  auto* s = static_cast<Store*>(h);
  return append_record(s, key, klen, val, vlen, false) ? 0 : -1;
}

// Returns pointer to the value (owned by the store, valid until the
// next call) and sets *vlen; nullptr when absent.
const uint8_t* kv_get(void* h, const uint8_t* key, uint32_t klen,
                      uint32_t* vlen) {
  auto* s = static_cast<Store*>(h);
  auto it = s->index.find(
      std::string(reinterpret_cast<const char*>(key), klen));
  if (it == s->index.end()) return nullptr;
  s->last_value.resize(it->second.second);
  std::fseek(s->f, static_cast<long>(it->second.first), SEEK_SET);
  if (!read_exact(s->f, s->last_value.data(), it->second.second)) {
    std::fseek(s->f, 0, SEEK_END);
    return nullptr;
  }
  std::fseek(s->f, 0, SEEK_END);
  *vlen = it->second.second;
  return s->last_value.data();
}

int kv_delete(void* h, const uint8_t* key, uint32_t klen) {
  auto* s = static_cast<Store*>(h);
  std::string k(reinterpret_cast<const char*>(key), klen);
  if (s->index.find(k) == s->index.end()) return 0;
  return append_record(s, key, klen, nullptr, 0, true) ? 0 : -1;
}

// Atomic batch commit.  `payload` is `count` concatenated records in
// the standard on-disk format (tombstones via vlen = 0xFFFFFFFF); the
// store brackets them with BEGIN/COMMIT markers, optionally fsyncs
// (kv_config), and applies them to the index only after the marker
// write succeeded.  On ANY failure the log is truncated back to the
// batch start — all-or-nothing on disk AND in memory.
int kv_write_batch(void* h, const uint8_t* payload, uint64_t payload_len,
                   uint32_t count) {
  auto* s = static_cast<Store*>(h);
  std::fseek(s->f, 0, SEEK_END);
  const uint64_t start = static_cast<uint64_t>(std::ftell(s->f));

  // parse + bounds-check the payload BEFORE writing anything
  std::vector<std::tuple<std::string, uint64_t, uint32_t>> staged;
  uint64_t off = 0;
  while (off < payload_len) {
    if (off + 8 > payload_len) return -1;
    const uint32_t klen = load_u32(payload + off);
    const uint32_t vlen = load_u32(payload + off + 4);
    if (klen >= kKlenMax) return -1;
    if (off + 8 + klen > payload_len) return -1;
    std::string key(reinterpret_cast<const char*>(payload + off + 8), klen);
    off += 8 + klen;
    if (vlen == kTomb) {
      staged.emplace_back(std::move(key), UINT64_MAX, 0);
      continue;
    }
    if (off + vlen > payload_len) return -1;
    // voff is relative for now; rebased after the BEGIN marker lands
    staged.emplace_back(std::move(key), off, vlen);
    off += vlen;
  }
  if (staged.size() != count) return -1;

  uint8_t hdr[8];
  store_u32(hdr, kBatchBegin);
  store_u32(hdr + 4, count);
  bool ok = std::fwrite(hdr, 1, 8, s->f) == 8;
  if (ok && payload_len) {
    ok = std::fwrite(payload, 1, payload_len, s->f) == payload_len;
  }
  if (ok) {
    store_u32(hdr, kBatchCommit);
    store_u32(hdr + 4, count);
    ok = std::fwrite(hdr, 1, 8, s->f) == 8;
  }
  if (!ok) {
    std::fflush(s->f);
    truncate(s->path.c_str(), static_cast<off_t>(start));
    std::freopen(s->path.c_str(), "r+b", s->f);
    std::fseek(s->f, 0, SEEK_END);
    return -1;
  }
  if (s->fsync_batch) {
    std::fflush(s->f);
    fsync(fileno(s->f));
  }
  const uint64_t base = start + 8;  // payload begins after BEGIN marker
  for (auto& [key, voff, vlen] : staged) {
    if (voff == UINT64_MAX) {
      s->index.erase(key);
    } else {
      s->index[std::move(key)] = {base + voff, vlen};
    }
  }
  return 0;
}

// Store configuration: currently one knob, fsync-on-batch-commit
// (0 = OS-buffered, 1 = durable batch commits).
int kv_config(void* h, int fsync_batch) {
  static_cast<Store*>(h)->fsync_batch = fsync_batch ? 1 : 0;
  return 0;
}

int kv_has(void* h, const uint8_t* key, uint32_t klen) {
  auto* s = static_cast<Store*>(h);
  return s->index.count(
             std::string(reinterpret_cast<const char*>(key), klen))
             ? 1
             : 0;
}

uint64_t kv_len(void* h) {
  return static_cast<Store*>(h)->index.size();
}

int kv_flush(void* h) {
  // flush() is the DURABILITY call (FileKV.flush os.fsync's): stdio
  // flush alone only reaches the page cache and would silently break
  // the SafetyStore's written-durably-before-broadcast guarantee on
  // the native (default) path
  auto* s = static_cast<Store*>(h);
  if (std::fflush(s->f) != 0) return -1;
  return fsync(fileno(s->f)) == 0 ? 0 : -1;
}

// Rewrite live records; reclaims tombstones and stale puts.
int kv_compact(void* h) {
  auto* s = static_cast<Store*>(h);
  const std::string tmp_path = s->path + ".compact";
  std::FILE* out = std::fopen(tmp_path.c_str(), "wb");
  if (out == nullptr) return -1;
  std::vector<uint8_t> val;
  for (const auto& [key, loc] : s->index) {
    val.resize(loc.second);
    std::fseek(s->f, static_cast<long>(loc.first), SEEK_SET);
    if (!read_exact(s->f, val.data(), loc.second)) {
      std::fclose(out);
      std::remove(tmp_path.c_str());
      return -1;
    }
    uint8_t hdr[8];
    store_u32(hdr, static_cast<uint32_t>(key.size()));
    store_u32(hdr + 4, loc.second);
    std::fwrite(hdr, 1, 8, out);
    std::fwrite(key.data(), 1, key.size(), out);
    std::fwrite(val.data(), 1, loc.second, out);
  }
  std::fflush(out);
  fsync(fileno(out));  // data must hit disk BEFORE the rename commits
  std::fclose(out);
  std::fclose(s->f);
  if (std::rename(tmp_path.c_str(), s->path.c_str()) != 0) {
    s->f = std::fopen(s->path.c_str(), "r+b");
    return -1;
  }
  s->f = std::fopen(s->path.c_str(), "r+b");
  s->index.clear();
  replay(s);
  return 0;
}

void kv_close(void* h) {
  delete static_cast<Store*>(h);
}

}  // extern "C"
