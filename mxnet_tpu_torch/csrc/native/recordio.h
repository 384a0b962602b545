// RecordIO binary framing of the port's native runtime, reader and
// writer: a copy of src/io/recordio.h (the JAX package's). Each record is
//   uint32 magic(0xced7230a) | uint32 (cflag<<29|len) | payload | pad4
// byte for byte as mxnet_tpu_torch/recordio.py writes and reads it.
#ifndef MXT_NATIVE_RECORDIO_H_
#define MXT_NATIVE_RECORDIO_H_

#include <cstdint>
#include <cstdio>
#include <string>
#include <vector>

namespace mxt_native {
namespace io {

constexpr uint32_t kRecordMagic = 0xced7230a;

class RecordReader {
 public:
  explicit RecordReader(const std::string& path);
  ~RecordReader();
  // Read the next logical record into *out. Returns false at EOF.
  bool Next(std::string* out);
  void Reset();
  // Seek to a byte offset (for indexed access).
  void Seek(uint64_t pos);

 private:
  bool FillChunk();
  std::FILE* fp_;
  std::vector<char> chunk_;   // buffered chunk
  size_t chunk_pos_ = 0;
  size_t chunk_len_ = 0;
  size_t chunk_capacity_;
};

class RecordWriter {
 public:
  explicit RecordWriter(const std::string& path);
  ~RecordWriter();
  // Returns the byte offset the record was written at.
  uint64_t Write(const char* data, size_t size);

 private:
  std::FILE* fp_;
};

// Image record header (recordio.IRHeader, struct IfQQ little-endian).
#pragma pack(push, 1)
struct IRHeader {
  uint32_t flag;
  float label;
  uint64_t id;
  uint64_t id2;
};
#pragma pack(pop)
static_assert(sizeof(IRHeader) == 24, "IRHeader must pack to 24 bytes");

}  // namespace io
}  // namespace mxt_native

#endif  // MXT_NATIVE_RECORDIO_H_
