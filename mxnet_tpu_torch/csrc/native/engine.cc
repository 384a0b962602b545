// ThreadedEngine implementation (see engine.h), a copy of
// src/engine/engine.cc.
// Dependency semantics mirror the reference scheduler
// (reference src/engine/threaded_engine.cc CompleteReadDependency /
// CompleteWriteDependency :144-156): per-var FIFO, concurrent readers,
// exclusive writers, atomic op wait counts.
#include "engine.h"

#include "logging.h"

namespace mxt_native {
namespace engine {

ThreadedEngine::ThreadedEngine(int num_workers) {
  if (num_workers < 1) num_workers = 1;
  for (int i = 0; i < num_workers; ++i) {
    workers_.emplace_back([this] { WorkerLoop(); });
  }
}

ThreadedEngine::~ThreadedEngine() {
  // drain WITHOUT RethrowPendingError: destructors are noexcept and a
  // latched op error must not std::terminate the process
  {
    std::unique_lock<std::mutex> lk(finished_mu_);
    finished_cv_.wait(lk, [this] { return pending_.load() == 0; });
  }
  {
    std::lock_guard<std::mutex> lk(queue_mu_);
    shutdown_ = true;
  }
  queue_cv_.notify_all();
  for (auto& t : workers_) t.join();
}

VarHandle ThreadedEngine::NewVariable() {
  VarHandle h = next_var_.fetch_add(1);
  std::lock_guard<std::mutex> lk(vars_mu_);
  vars_[h] = std::unique_ptr<Var>(new Var());
  return h;
}

void ThreadedEngine::TryDispatchHead(Var* v, std::vector<Opr*>* ready) {
  // caller holds v->mu
  while (!v->queue.empty()) {
    Var::Block head = v->queue.front();
    if (head.write) {
      if (v->running_readers == 0 && !v->writer_running) {
        v->writer_running = true;
        v->queue.pop_front();
        if (head.opr->wait.fetch_sub(1) == 1) ready->push_back(head.opr);
      }
      break;
    }
    if (v->writer_running) break;
    ++v->running_readers;
    v->queue.pop_front();
    if (head.opr->wait.fetch_sub(1) == 1) ready->push_back(head.opr);
  }
}

void ThreadedEngine::Push(OpFn fn,
                          const std::vector<VarHandle>& const_vars,
                          const std::vector<VarHandle>& mutable_vars) {
  // unique_ptr until fully validated, so a CHECK throw doesn't leak
  std::unique_ptr<Opr> guard(new Opr());
  Opr* opr = guard.get();
  opr->fn = std::move(fn);
  {
    std::lock_guard<std::mutex> lk(vars_mu_);
    for (VarHandle h : const_vars) {
      auto it = vars_.find(h);
      MXT_CHECK(it != vars_.end()) << "unknown const var " << h;
      opr->const_vars.push_back(it->second.get());
    }
    for (VarHandle h : mutable_vars) {
      auto it = vars_.find(h);
      MXT_CHECK(it != vars_.end()) << "unknown mutable var " << h;
      opr->mutable_vars.push_back(it->second.get());
    }
  }
  // full CheckDuplicate semantics (reference threaded_engine.h:376):
  // no overlap across lists AND no duplicates within either list
  for (size_t i = 0; i < opr->const_vars.size(); ++i)
    for (size_t j = i + 1; j < opr->const_vars.size(); ++j)
      MXT_CHECK(opr->const_vars[i] != opr->const_vars[j])
          << "duplicate var in const_vars";
  for (size_t i = 0; i < opr->mutable_vars.size(); ++i)
    for (size_t j = i + 1; j < opr->mutable_vars.size(); ++j)
      MXT_CHECK(opr->mutable_vars[i] != opr->mutable_vars[j])
          << "duplicate var in mutable_vars";
  for (Var* cv : opr->const_vars) {
    for (Var* mv : opr->mutable_vars) {
      MXT_CHECK(cv != mv)
          << "a var may not be both const and mutable in one op";
    }
  }
  guard.release();
  pending_.fetch_add(1);
  opr->wait.store(static_cast<int>(opr->const_vars.size() +
                                   opr->mutable_vars.size()) + 1);
  std::vector<Opr*> ready;
  for (Var* v : opr->const_vars) {
    std::lock_guard<std::mutex> lk(v->mu);
    v->queue.push_back({opr, false});
    TryDispatchHead(v, &ready);
  }
  for (Var* v : opr->mutable_vars) {
    std::lock_guard<std::mutex> lk(v->mu);
    v->queue.push_back({opr, true});
    TryDispatchHead(v, &ready);
  }
  // release the +1 guard (covers the zero-deps case exactly once)
  if (opr->wait.fetch_sub(1) == 1) ready.push_back(opr);
  for (Opr* r : ready) Schedule(r);
}

void ThreadedEngine::Schedule(Opr* opr) {
  {
    std::lock_guard<std::mutex> lk(queue_mu_);
    task_queue_.push(opr);
  }
  queue_cv_.notify_one();
}

void ThreadedEngine::WorkerLoop() {
  for (;;) {
    Opr* opr = nullptr;
    {
      std::unique_lock<std::mutex> lk(queue_mu_);
      queue_cv_.wait(lk, [this] { return shutdown_ || !task_queue_.empty(); });
      if (task_queue_.empty()) return;  // shutdown
      opr = task_queue_.front();
      task_queue_.pop();
    }
    try {
      opr->fn();
    } catch (const std::exception& e) {
      std::cerr << "[mxt engine] op threw: " << e.what() << std::endl;
      std::lock_guard<std::mutex> lk(error_mu_);
      if (first_error_.empty()) first_error_ = e.what();
    }
    OnComplete(opr);
  }
}

void ThreadedEngine::OnComplete(Opr* opr) {
  std::vector<Opr*> ready;
  std::vector<Var*> maybe_delete;
  for (Var* v : opr->const_vars) {
    std::lock_guard<std::mutex> lk(v->mu);
    --v->running_readers;
    TryDispatchHead(v, &ready);
    if (v->to_delete && v->queue.empty() && v->running_readers == 0 &&
        !v->writer_running) {
      maybe_delete.push_back(v);
    }
  }
  for (Var* v : opr->mutable_vars) {
    std::lock_guard<std::mutex> lk(v->mu);
    v->writer_running = false;
    TryDispatchHead(v, &ready);
    if (v->to_delete && v->queue.empty() && v->running_readers == 0 &&
        !v->writer_running) {
      maybe_delete.push_back(v);
    }
  }
  delete opr;
  for (Opr* r : ready) Schedule(r);
  if (!maybe_delete.empty()) {
    std::lock_guard<std::mutex> lk(vars_mu_);
    for (auto it = vars_.begin(); it != vars_.end();) {
      bool erase = false;
      for (Var* v : maybe_delete) {
        if (it->second.get() == v) { erase = true; break; }
      }
      it = erase ? vars_.erase(it) : std::next(it);
    }
  }
  if (pending_.fetch_sub(1) == 1) {
    std::lock_guard<std::mutex> lk(finished_mu_);
    finished_cv_.notify_all();
  }
}

void ThreadedEngine::WaitForVar(VarHandle var) {
  std::mutex mu;
  std::condition_variable cv;
  bool done = false;
  Push(
      [&] {
        std::lock_guard<std::mutex> lk(mu);
        done = true;
        cv.notify_all();
      },
      {var}, {});
  std::unique_lock<std::mutex> lk(mu);
  cv.wait(lk, [&] { return done; });
  RethrowPendingError();
}

void ThreadedEngine::WaitForAll() {
  std::unique_lock<std::mutex> lk(finished_mu_);
  finished_cv_.wait(lk, [this] { return pending_.load() == 0; });
  RethrowPendingError();
}

void ThreadedEngine::RethrowPendingError() {
  std::string err;
  {
    std::lock_guard<std::mutex> lk(error_mu_);
    err.swap(first_error_);
  }
  if (!err.empty()) throw std::runtime_error("engine op failed: " + err);
}

void ThreadedEngine::DeleteVariable(VarHandle var) {
  std::lock_guard<std::mutex> gl(vars_mu_);
  auto it = vars_.find(var);
  if (it == vars_.end()) return;
  Var* v = it->second.get();
  bool idle;
  {
    std::lock_guard<std::mutex> lk(v->mu);
    v->to_delete = true;
    idle = v->queue.empty() && v->running_readers == 0 &&
           !v->writer_running;
  }
  if (idle) vars_.erase(it);
}

}  // namespace engine
}  // namespace mxt_native
