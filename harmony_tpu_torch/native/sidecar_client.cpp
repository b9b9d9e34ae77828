// Native sidecar client: the C++ half of the node <-> TPU-kernel-server
// boundary (harmony_tpu/sidecar/protocol.py defines the wire format).
//
// In deployment the chain node (Go, linking this via cgo the way the
// reference links herumi's libbls) calls these functions instead of an
// in-process pairing library; the heavy crypto happens in the persistent
// kernel server process.  Exposed as a C ABI so ctypes/cgo/FFI all work.
//
// Protocol v1 (little-endian):
//   frame  = [u32 len][u8 type][u32 req_id][body]; responses set type bit 7
//   bodies = see harmony_tpu/sidecar/protocol.py

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <string>
#include <vector>

#include <arpa/inet.h>
#include <netinet/in.h>
#include <netinet/tcp.h>
#include <sys/socket.h>
#include <sys/un.h>
#include <unistd.h>

namespace {

constexpr uint8_t kMsgPing = 0x01;
constexpr uint8_t kMsgSetCommittee = 0x02;
constexpr uint8_t kMsgAggVerify = 0x03;
constexpr uint8_t kRespFlag = 0x80;
constexpr uint32_t kMaxFrame = 2 * 1024 * 1024;
constexpr size_t kPubkeyBytes = 48;
constexpr size_t kSigBytes = 96;

void put_u16(std::vector<uint8_t>& out, uint16_t v) {
  out.push_back(v & 0xff);
  out.push_back((v >> 8) & 0xff);
}

void put_u32(std::vector<uint8_t>& out, uint32_t v) {
  for (int i = 0; i < 4; ++i) out.push_back((v >> (8 * i)) & 0xff);
}

void put_u64(std::vector<uint8_t>& out, uint64_t v) {
  for (int i = 0; i < 8; ++i) out.push_back((v >> (8 * i)) & 0xff);
}

bool write_all(int fd, const uint8_t* data, size_t len) {
  while (len > 0) {
    ssize_t n = ::write(fd, data, len);
    if (n <= 0) {
      if (n < 0 && errno == EINTR) continue;
      return false;
    }
    data += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

bool read_all(int fd, uint8_t* data, size_t len) {
  while (len > 0) {
    ssize_t n = ::read(fd, data, len);
    if (n <= 0) {
      if (n < 0 && errno == EINTR) continue;
      return false;
    }
    data += n;
    len -= static_cast<size_t>(n);
  }
  return true;
}

struct Client {
  int fd = -1;
  uint32_t next_req_id = 1;
};

// Sends one request frame and reads the matching response.  Returns the
// response status (>= 0) or a negative transport error.
int roundtrip(Client* c, uint8_t msg_type, const std::vector<uint8_t>& body,
              std::vector<uint8_t>* resp_body) {
  uint32_t req_id = c->next_req_id++;
  std::vector<uint8_t> frame;
  frame.reserve(9 + body.size());
  put_u32(frame, static_cast<uint32_t>(1 + 4 + body.size()));
  frame.push_back(msg_type);
  put_u32(frame, req_id);
  frame.insert(frame.end(), body.begin(), body.end());
  if (!write_all(c->fd, frame.data(), frame.size())) return -1;

  uint8_t hdr[4];
  if (!read_all(c->fd, hdr, 4)) return -2;
  uint32_t len = hdr[0] | (hdr[1] << 8) | (hdr[2] << 16)
      | (static_cast<uint32_t>(hdr[3]) << 24);
  if (len < 6 || len > kMaxFrame) return -3;
  std::vector<uint8_t> data(len);
  if (!read_all(c->fd, data.data(), len)) return -4;
  uint8_t rtype = data[0];
  uint32_t rid = data[1] | (data[2] << 8) | (data[3] << 16)
      | (static_cast<uint32_t>(data[4]) << 24);
  if (rtype != (msg_type | kRespFlag) || rid != req_id) return -5;
  uint8_t status = data[5];
  if (resp_body) resp_body->assign(data.begin() + 6, data.end());
  return status;
}

}  // namespace

extern "C" {

// Connect over TCP; returns an opaque handle or null.
void* harmony_sidecar_connect_tcp(const char* host, int port) {
  int fd = ::socket(AF_INET, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  sockaddr_in addr{};
  addr.sin_family = AF_INET;
  addr.sin_port = htons(static_cast<uint16_t>(port));
  if (::inet_pton(AF_INET, host, &addr.sin_addr) != 1 ||
      ::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    return nullptr;
  }
  int one = 1;
  ::setsockopt(fd, IPPROTO_TCP, TCP_NODELAY, &one, sizeof(one));
  auto* c = new Client();
  c->fd = fd;
  return c;
}

// Connect over a Unix socket; returns an opaque handle or null.
void* harmony_sidecar_connect_unix(const char* path) {
  int fd = ::socket(AF_UNIX, SOCK_STREAM, 0);
  if (fd < 0) return nullptr;
  sockaddr_un addr{};
  addr.sun_family = AF_UNIX;
  std::strncpy(addr.sun_path, path, sizeof(addr.sun_path) - 1);
  if (::connect(fd, reinterpret_cast<sockaddr*>(&addr), sizeof(addr)) != 0) {
    ::close(fd);
    return nullptr;
  }
  auto* c = new Client();
  c->fd = fd;
  return c;
}

void harmony_sidecar_close(void* handle) {
  auto* c = static_cast<Client*>(handle);
  if (!c) return;
  if (c->fd >= 0) ::close(c->fd);
  delete c;
}

// Returns the server protocol version (> 0) or a negative error.
int harmony_sidecar_ping(void* handle) {
  auto* c = static_cast<Client*>(handle);
  std::vector<uint8_t> resp;
  int status = roundtrip(c, kMsgPing, {}, &resp);
  if (status != 0) return status > 0 ? -100 - status : status;
  if (resp.size() < 2) return -6;
  return resp[0] | (resp[1] << 8);
}

// Upload a committee's pubkeys (n * 48 bytes).  Returns 0 on success.
int harmony_sidecar_set_committee(void* handle, uint64_t epoch, uint32_t shard,
                                  const uint8_t* pubkeys, uint32_t n) {
  auto* c = static_cast<Client*>(handle);
  std::vector<uint8_t> body;
  body.reserve(16 + n * kPubkeyBytes);
  put_u64(body, epoch);
  put_u32(body, shard);
  put_u32(body, n);
  body.insert(body.end(), pubkeys, pubkeys + n * kPubkeyBytes);
  int status = roundtrip(c, kMsgSetCommittee, body, nullptr);
  return status == 0 ? 0 : (status > 0 ? status : status);
}

// Aggregate-verify: bitmap-masked committee aggregate vs a 96-byte sig
// over `payload`.  Returns 1 valid, 0 invalid, negative on error.
int harmony_sidecar_agg_verify(void* handle, uint64_t epoch, uint32_t shard,
                               const uint8_t* payload, uint16_t payload_len,
                               const uint8_t* bitmap, uint16_t bitmap_len,
                               const uint8_t* sig96) {
  auto* c = static_cast<Client*>(handle);
  std::vector<uint8_t> body;
  body.reserve(14 + payload_len + 2 + bitmap_len + kSigBytes);
  put_u64(body, epoch);
  put_u32(body, shard);
  put_u16(body, payload_len);
  body.insert(body.end(), payload, payload + payload_len);
  put_u16(body, bitmap_len);
  body.insert(body.end(), bitmap, bitmap + bitmap_len);
  body.insert(body.end(), sig96, sig96 + kSigBytes);
  std::vector<uint8_t> resp;
  int status = roundtrip(c, kMsgAggVerify, body, &resp);
  if (status != 0) return status > 0 ? -100 - status : status;
  if (resp.empty()) return -6;
  return resp[0] ? 1 : 0;
}

}  // extern "C"
