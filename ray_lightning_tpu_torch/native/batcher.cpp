// rlt_batcher — threaded host-side batch assembly with prefetch.
//
// The TPU-native stand-in for the data-path work the reference delegated
// to Ray's C++ core (plasma object transport feeding torch DataLoader
// workers; reference ray_lightning/ray_ddp.py ships whole datasets through
// ray.put). Here the hot host-side op is "gather N shuffled rows into a
// contiguous batch buffer" — done by a worker pool one-or-more batches
// AHEAD of the training loop, so batch assembly overlaps device compute
// instead of serializing with it.
//
// Model: a ring of `depth` slots, each holding one assembled batch for
// every array in the dataset pytree. Worker threads claim batch indices,
// gather rows (memcpy per row; rows are contiguous because arrays are
// C-order with the batch dim leading), and publish READY slots. The
// consumer takes batches strictly in order (static shapes; deterministic
// iteration), and releases each slot once the batch is on device.
//
// Plain C ABI (ctypes-friendly, no pybind11 dependency).

#include <atomic>
#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

enum class SlotState { kFree, kFilling, kReady, kInUse };

struct Slot {
  std::vector<std::vector<uint8_t>> buffers;  // one per array
  int64_t batch_index = -1;
  int64_t rows = 0;
  SlotState state = SlotState::kFree;
};

struct Loader {
  // dataset
  int n_arrays = 0;
  std::vector<const uint8_t*> data;
  std::vector<int64_t> row_bytes;
  int64_t n_rows = 0;
  int64_t batch_size = 0;
  bool drop_last = true;

  // epoch state
  std::vector<int64_t> order;
  int64_t n_batches = 0;
  int64_t next_fill = 0;   // next batch index a worker should claim
  int64_t next_serve = 0;  // next batch index the consumer receives

  // machinery
  std::vector<Slot> slots;
  std::vector<std::thread> workers;
  std::mutex mu;
  std::condition_variable cv;  // all waiting (workers + consumer)
  bool stopping = false;

  ~Loader() {
    {
      std::lock_guard<std::mutex> lk(mu);
      stopping = true;
    }
    cv.notify_all();
    for (auto& t : workers) t.join();
  }
};

int64_t batch_rows(const Loader& L, int64_t b) {
  int64_t start = b * L.batch_size;
  int64_t n = static_cast<int64_t>(L.order.size());
  return std::min(L.batch_size, n - start);
}

void fill_slot(Loader& L, Slot& slot, int64_t b) {
  const int64_t rows = batch_rows(L, b);
  const int64_t* idx = L.order.data() + b * L.batch_size;
  for (int a = 0; a < L.n_arrays; ++a) {
    const int64_t rb = L.row_bytes[a];
    uint8_t* dst = slot.buffers[a].data();
    const uint8_t* src = L.data[a];
    for (int64_t r = 0; r < rows; ++r) {
      std::memcpy(dst + r * rb, src + idx[r] * rb, rb);
    }
  }
  slot.rows = rows;
  slot.batch_index = b;
}

void worker_main(Loader* L) {
  std::unique_lock<std::mutex> lk(L->mu);
  while (true) {
    Slot* slot = nullptr;
    int64_t b = -1;
    L->cv.wait(lk, [&] {
      if (L->stopping) return true;
      if (L->next_fill >= L->n_batches) return false;  // epoch drained
      for (auto& s : L->slots) {
        if (s.state == SlotState::kFree) return true;
      }
      return false;
    });
    if (L->stopping) return;
    for (auto& s : L->slots) {
      if (s.state == SlotState::kFree) {
        slot = &s;
        break;
      }
    }
    b = L->next_fill++;
    slot->state = SlotState::kFilling;
    lk.unlock();
    fill_slot(*L, *slot, b);
    lk.lock();
    slot->state = SlotState::kReady;
    L->cv.notify_all();
  }
}

}  // namespace

extern "C" {

void* rlt_loader_create(int n_arrays, const void** data,
                        const int64_t* row_bytes, int64_t n_rows,
                        int64_t batch_size, int drop_last, int depth,
                        int n_threads) {
  if (n_arrays <= 0 || n_rows <= 0 || batch_size <= 0) return nullptr;
  auto* L = new Loader();
  L->n_arrays = n_arrays;
  L->n_rows = n_rows;
  L->batch_size = batch_size;
  L->drop_last = drop_last != 0;
  for (int a = 0; a < n_arrays; ++a) {
    L->data.push_back(static_cast<const uint8_t*>(data[a]));
    L->row_bytes.push_back(row_bytes[a]);
  }
  depth = depth < 2 ? 2 : depth;
  L->slots.resize(depth);
  for (auto& s : L->slots) {
    s.buffers.resize(n_arrays);
    for (int a = 0; a < n_arrays; ++a) {
      s.buffers[a].resize(batch_size * L->row_bytes[a]);
    }
  }
  n_threads = n_threads < 1 ? 1 : n_threads;
  for (int t = 0; t < n_threads; ++t) {
    L->workers.emplace_back(worker_main, L);
  }
  return L;
}

// Begin an epoch. `order` is the (possibly shuffled, possibly sharded)
// row-index sequence for this epoch. Safe to call with the previous
// epoch only partially consumed (the trainer breaks out of iteration on
// limit_train_batches / max_steps / early stop): new claims are fenced
// off first, then in-flight fills are drained before `order` and the
// slot states are touched — fill_slot reads/writes outside the mutex.
void rlt_loader_set_epoch(void* handle, const int64_t* order, int64_t n) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::unique_lock<std::mutex> lk(L->mu);
    L->n_batches = 0;  // no worker can claim a new batch past this point
    L->cv.wait(lk, [&] {
      for (auto& s : L->slots) {
        if (s.state == SlotState::kFilling) return false;
      }
      return true;
    });
    L->order.assign(order, order + n);
    L->n_batches = L->drop_last ? n / L->batch_size
                                : (n + L->batch_size - 1) / L->batch_size;
    L->next_fill = 0;
    L->next_serve = 0;
    for (auto& s : L->slots) {
      s.state = SlotState::kFree;
      s.batch_index = -1;
    }
  }
  L->cv.notify_all();
}

// Blocks until the next in-order batch is assembled. Fills `out_ptrs`
// (one pointer per array) and `out_rows`. Returns the slot id to pass to
// rlt_loader_release, or -1 at end of epoch.
int rlt_loader_next(void* handle, void** out_ptrs, int64_t* out_rows) {
  auto* L = static_cast<Loader*>(handle);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->next_serve >= L->n_batches) return -1;
  const int64_t want = L->next_serve;
  Slot* slot = nullptr;
  L->cv.wait(lk, [&] {
    if (L->stopping) return true;
    for (auto& s : L->slots) {
      if (s.state == SlotState::kReady && s.batch_index == want) {
        slot = &s;
        return true;
      }
    }
    return false;
  });
  if (L->stopping || slot == nullptr) return -1;
  slot->state = SlotState::kInUse;
  L->next_serve++;
  for (int a = 0; a < L->n_arrays; ++a) {
    out_ptrs[a] = slot->buffers[a].data();
  }
  *out_rows = slot->rows;
  return static_cast<int>(slot - L->slots.data());
}

void rlt_loader_release(void* handle, int slot_id) {
  auto* L = static_cast<Loader*>(handle);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    if (slot_id >= 0 && slot_id < static_cast<int>(L->slots.size())) {
      L->slots[slot_id].state = SlotState::kFree;
      L->slots[slot_id].batch_index = -1;
    }
  }
  L->cv.notify_all();
}

void rlt_loader_destroy(void* handle) {
  delete static_cast<Loader*>(handle);
}

}  // extern "C"
