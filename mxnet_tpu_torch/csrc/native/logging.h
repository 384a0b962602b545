// Minimal logging/CHECK facility of the port's native runtime: a copy of
// src/common/logging.h (the JAX package's) in the port's own namespace.
#ifndef MXT_NATIVE_LOGGING_H_
#define MXT_NATIVE_LOGGING_H_

#include <cstdlib>
#include <iostream>
#include <sstream>
#include <stdexcept>
#include <string>

namespace mxt_native {

struct Error : public std::runtime_error {
  explicit Error(const std::string& msg) : std::runtime_error(msg) {}
};

class LogMessage {
 public:
  LogMessage(const char* file, int line, bool fatal)
      : fatal_(fatal) {
    stream_ << "[" << file << ":" << line << "] ";
  }
  std::ostringstream& stream() { return stream_; }
  ~LogMessage() noexcept(false) {
    if (fatal_) {
      throw Error(stream_.str());
    } else {
      std::cerr << stream_.str() << std::endl;
    }
  }

 private:
  std::ostringstream stream_;
  bool fatal_;
};

}  // namespace mxt_native

#define MXT_LOG_INFO ::mxt_native::LogMessage(__FILE__, __LINE__, false).stream()
#define MXT_LOG_FATAL ::mxt_native::LogMessage(__FILE__, __LINE__, true).stream()

#define MXT_CHECK(x)                                   \
  if (!(x))                                              \
  ::mxt_native::LogMessage(__FILE__, __LINE__, true).stream() \
      << "Check failed: " #x " "

#define MXT_CHECK_EQ(a, b) MXT_CHECK((a) == (b))
#define MXT_CHECK_NE(a, b) MXT_CHECK((a) != (b))
#define MXT_CHECK_GT(a, b) MXT_CHECK((a) > (b))
#define MXT_CHECK_GE(a, b) MXT_CHECK((a) >= (b))
#define MXT_CHECK_LT(a, b) MXT_CHECK((a) < (b))
#define MXT_CHECK_LE(a, b) MXT_CHECK((a) <= (b))

#endif  // MXT_NATIVE_LOGGING_H_
