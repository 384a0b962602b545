// Async dependency-scheduling engine of the port's native runtime, a copy
// of src/engine/engine.h (the JAX package's), after the reference's
// ThreadedEngine (threaded_engine.{h,cc}: per-variable queues, atomic op
// wait counts, a fixed worker pool). Ops declare const (read) and mutable
// (write) variables; an op runs when all its dependencies clear. The
// engine orders host work: IO stages, checkpoint writes, host-side
// updates. Device work that an op enqueues (torch ops on a CUDA stream)
// is ordered by its own stream, not by this engine.
#ifndef MXT_NATIVE_ENGINE_H_
#define MXT_NATIVE_ENGINE_H_

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <deque>
#include <functional>
#include <memory>
#include <mutex>
#include <queue>
#include <string>
#include <thread>
#include <unordered_map>
#include <vector>

namespace mxt_native {
namespace engine {

using OpFn = std::function<void()>;
using VarHandle = int64_t;

class ThreadedEngine {
 public:
  explicit ThreadedEngine(int num_workers);
  ~ThreadedEngine();

  VarHandle NewVariable();
  // Push an operation reading const_vars and writing mutable_vars.
  // Duplicate handles within/across the two lists are invalid
  // (reference CheckDuplicate, threaded_engine.h:376).
  void Push(OpFn fn, const std::vector<VarHandle>& const_vars,
            const std::vector<VarHandle>& mutable_vars);
  // Both wait calls throw std::runtime_error if any op failed since the
  // last wait (the reference propagates op errors through on_complete;
  // here the first error is latched and surfaced at the next sync point).
  void WaitForVar(VarHandle var);
  void WaitForAll();
  // Delete a variable once all pending ops on it complete.
  void DeleteVariable(VarHandle var);
  int num_workers() const { return static_cast<int>(workers_.size()); }

 private:
  struct Opr;

  // Per-variable dependency queue (reference ThreadedVar,
  // threaded_engine.h:111): pending readers/writer entries in order.
  struct Var {
    struct Block {
      Opr* opr;
      bool write;
    };
    std::mutex mu;
    std::deque<Block> queue;
    // number of currently running readers; -1 if a writer is running
    int running_readers = 0;
    bool writer_running = false;
    bool to_delete = false;
  };

  struct Opr {
    OpFn fn;
    std::vector<Var*> const_vars;
    std::vector<Var*> mutable_vars;
    std::atomic<int> wait{0};
  };

  void WorkerLoop();
  void Schedule(Opr* opr);
  void OnComplete(Opr* opr);
  // returns true if the op at the head can start now
  void TryDispatchHead(Var* v, std::vector<Opr*>* ready);

  std::vector<std::thread> workers_;
  std::queue<Opr*> task_queue_;
  std::mutex queue_mu_;
  std::condition_variable queue_cv_;
  bool shutdown_ = false;

  std::mutex vars_mu_;
  std::unordered_map<VarHandle, std::unique_ptr<Var>> vars_;
  std::atomic<int64_t> next_var_{1};

  std::atomic<int64_t> pending_{0};
  std::mutex finished_mu_;
  std::condition_variable finished_cv_;

  // first op failure since the last wait (latched, reported once)
  std::mutex error_mu_;
  std::string first_error_;
  void RethrowPendingError();
};

}  // namespace engine
}  // namespace mxt_native

#endif  // MXT_NATIVE_ENGINE_H_
