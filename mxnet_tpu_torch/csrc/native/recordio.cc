// RecordReader / RecordWriter (see recordio.h), a copy of
// src/io/recordio.cc.
#include "recordio.h"

#include <cstring>

#include "logging.h"

namespace mxt_native {
namespace io {

namespace {
constexpr size_t kChunkSize = 4 << 20;  // 4 MiB buffered reads
inline uint32_t DecodeFlag(uint32_t lrec) { return lrec >> 29; }
inline uint32_t DecodeLen(uint32_t lrec) {
  return lrec & ((1u << 29) - 1);
}
}  // namespace

RecordReader::RecordReader(const std::string& path)
    : chunk_capacity_(kChunkSize) {
  fp_ = std::fopen(path.c_str(), "rb");
  MXT_CHECK(fp_ != nullptr) << "cannot open " << path;
  chunk_.resize(chunk_capacity_);
}

RecordReader::~RecordReader() {
  if (fp_) std::fclose(fp_);
}

void RecordReader::Reset() { Seek(0); }

void RecordReader::Seek(uint64_t pos) {
  MXT_CHECK_EQ(std::fseek(fp_, static_cast<long>(pos), SEEK_SET), 0);
  chunk_pos_ = chunk_len_ = 0;  // drop buffered data
}

bool RecordReader::FillChunk() {
  // move any tail bytes to the front, refill the rest
  size_t remain = chunk_len_ - chunk_pos_;
  if (remain > 0) {
    std::memmove(chunk_.data(), chunk_.data() + chunk_pos_, remain);
  }
  chunk_pos_ = 0;
  chunk_len_ = remain;
  size_t got = std::fread(chunk_.data() + remain, 1,
                          chunk_capacity_ - remain, fp_);
  chunk_len_ += got;
  return chunk_len_ > 0;
}

bool RecordReader::Next(std::string* out) {
  out->clear();
  for (;;) {  // loop over multi-part records
    // ensure 8-byte header available
    while (chunk_len_ - chunk_pos_ < 8) {
      size_t before = chunk_len_ - chunk_pos_;
      if (!FillChunk() || chunk_len_ - chunk_pos_ == before) {
        MXT_CHECK(out->empty() && before == 0)
            << "truncated record at EOF";
        return false;
      }
    }
    uint32_t magic, lrec;
    std::memcpy(&magic, chunk_.data() + chunk_pos_, 4);
    std::memcpy(&lrec, chunk_.data() + chunk_pos_ + 4, 4);
    MXT_CHECK_EQ(magic, kRecordMagic) << "bad RecordIO magic";
    chunk_pos_ += 8;
    uint32_t cflag = DecodeFlag(lrec);
    uint32_t len = DecodeLen(lrec);
    uint32_t padded = len + ((4 - len % 4) % 4);
    size_t old = out->size();
    out->resize(old + len);
    size_t copied = 0;
    // copy payload (may span chunk refills)
    size_t to_skip = padded;
    while (copied < len) {
      if (chunk_pos_ == chunk_len_) {
        MXT_CHECK(FillChunk()) << "truncated record payload";
      }
      size_t avail = chunk_len_ - chunk_pos_;
      size_t take = std::min(avail, static_cast<size_t>(len) - copied);
      std::memcpy(&(*out)[old + copied], chunk_.data() + chunk_pos_, take);
      copied += take;
      chunk_pos_ += take;
      to_skip -= take;
    }
    // skip padding
    while (to_skip > 0) {
      if (chunk_pos_ == chunk_len_) {
        MXT_CHECK(FillChunk()) << "truncated record padding";
      }
      size_t take = std::min(chunk_len_ - chunk_pos_, to_skip);
      chunk_pos_ += take;
      to_skip -= take;
    }
    if (cflag == 0 || cflag == 3) return true;  // whole or end
  }
}

RecordWriter::RecordWriter(const std::string& path) {
  fp_ = std::fopen(path.c_str(), "wb");
  MXT_CHECK(fp_ != nullptr) << "cannot open " << path;
}

RecordWriter::~RecordWriter() {
  if (fp_) std::fclose(fp_);
}

uint64_t RecordWriter::Write(const char* data, size_t size) {
  uint64_t pos = static_cast<uint64_t>(std::ftell(fp_));
  uint32_t magic = kRecordMagic;
  uint32_t lrec = static_cast<uint32_t>(size);  // cflag=0 (whole)
  std::fwrite(&magic, 4, 1, fp_);
  std::fwrite(&lrec, 4, 1, fp_);
  std::fwrite(data, 1, size, fp_);
  static const char zeros[4] = {0, 0, 0, 0};
  size_t pad = (4 - size % 4) % 4;
  if (pad) std::fwrite(zeros, 1, pad, fp_);
  return pos;
}

}  // namespace io
}  // namespace mxt_native
