// Native batch-assembly prefetcher for the data-loading hot path.
//
// Reference relationship: the reference's input pipeline leaned on
// Chainer's MultiprocessIterator (worker *processes* assembling batches,
// SURVEY.md §2.9 "ImageNet ... MultiprocessIterator + scatter") because
// CPython threads can't copy batches in parallel under the GIL.  The
// TPU-native rebuild keeps the runtime in-process (one controller process
// per host talking to its chips) so the equivalent is worker *threads* in
// C++ that never touch the GIL: they gather records from a caller-owned
// buffer (in-memory or np.memmap'd) into a ring of pre-assembled batch
// slots, while Python only flips pointers.
//
// Contract (single consumer, in-order delivery):
//   h = pfl_create(data, record_bytes, n_records, batch_size, slots, thr)
//   pfl_set_order(h, indices, n)   // defines floor(n/batch) batches
//   while ((b = pfl_acquire(h, &p)) >= 0) { consume p; pfl_release(h); }
//   pfl_destroy(h)
//
// Build: g++ -O3 -std=c++17 -shared -fPIC -pthread (see runtime/__init__.py
// :: _build_library).

#include <fcntl.h>
#include <unistd.h>

#include <condition_variable>
#include <cstdint>
#include <cstring>
#include <mutex>
#include <thread>
#include <vector>

namespace {

struct Slot {
  std::vector<uint8_t> buf;
  int64_t batch = -1;  // which batch currently occupies this slot (-1 free)
  bool consumed = true;
};

struct Loader {
  const uint8_t* data;     // in-memory mode (null in file mode)
  int fd = -1;             // file mode: records pread() from data_offset
  int64_t data_offset = 0;
  bool io_error = false;   // sticky; surfaced via pfl_acquire() == -3
  int64_t record_bytes, n_records, batch_size;
  int n_slots;

  std::vector<Slot> slots;
  std::vector<int64_t> order;
  // All stream/claim state lives under `mu` — a claimed-but-unconsumed
  // batch blocks set_order, so no stale claims can poison a slot.
  int64_t n_batches = 0;
  int64_t next_build = 0;
  int64_t next_consume = 0;
  int64_t acquired = -1;  // slot index currently held by the consumer
  int64_t gen = 0;        // stream generation; pfl_cancel bumps it so
                          // workers parked on a cancelled stream's claims
                          // drop them instead of filling from a stale order

  std::mutex mu;
  std::condition_variable cv_slot_free, cv_batch_ready;
  bool stop = false;
  int filling = 0;  // workers currently copying outside the lock
  std::vector<std::thread> workers;

  // Returns false on I/O failure (file mode only); the caller marks the
  // loader poisoned rather than publishing a half-filled batch.
  bool fill(int64_t b, Slot& slot) {
    const int64_t* idx = order.data() + b * batch_size;
    for (int64_t r = 0; r < batch_size; ++r) {
      uint8_t* dst = slot.buf.data() + r * record_bytes;
      if (fd >= 0) {
        int64_t off = data_offset + idx[r] * record_bytes;
        int64_t done = 0;
        while (done < record_bytes) {
          ssize_t got = pread(fd, dst + done,
                              static_cast<size_t>(record_bytes - done),
                              static_cast<off_t>(off + done));
          if (got <= 0) return false;  // EOF mid-record or read error
          done += got;
        }
      } else {
        std::memcpy(dst, data + idx[r] * record_bytes,
                    static_cast<size_t>(record_bytes));
      }
    }
    return true;
  }

  void work() {
    std::unique_lock<std::mutex> lk(mu);
    for (;;) {
      // Claim the next batch of the current stream (park when exhausted).
      while (!stop && next_build >= n_batches) cv_slot_free.wait(lk);
      if (stop) return;
      int64_t g = gen;
      int64_t b = next_build++;
      // Turn gate: fill only once the slot's previous occupant (batch
      // b - n_slots) has been CONSUMED.  A bare slot.consumed check is
      // racy — the worker holding batch b+n_slots could steal the slot
      // the moment the consumer frees it, deadlocking batch b.
      Slot& slot = slots[b % n_slots];
      while (!stop && gen == g && next_consume + n_slots <= b)
        cv_slot_free.wait(lk);
      if (stop) return;
      if (gen != g) continue;  // stream cancelled while parked: drop claim
      slot.consumed = false;
      slot.batch = -1;  // mark "filling"
      ++filling;
      lk.unlock();
      bool ok = fill(b, slot);  // the GIL-free hot copy, outside the lock
      lk.lock();
      --filling;
      if (!ok) io_error = true;          // poison: consumer sees -3
      else if (gen == g) slot.batch = b; // publish only into the same stream
      cv_batch_ready.notify_all();
    }
  }
};

}  // namespace

extern "C" {

void* pfl_create(const void* data, int64_t record_bytes, int64_t n_records,
                 int64_t batch_size, int n_slots, int n_threads) {
  if (record_bytes <= 0 || batch_size <= 0 || n_slots < 2 || n_threads < 1)
    return nullptr;
  auto* L = new Loader();
  L->data = static_cast<const uint8_t*>(data);
  L->record_bytes = record_bytes;
  L->n_records = n_records;
  L->batch_size = batch_size;
  L->n_slots = n_slots;
  L->slots.resize(n_slots);
  for (auto& s : L->slots)
    s.buf.resize(static_cast<size_t>(batch_size * record_bytes));
  for (int i = 0; i < n_threads; ++i)
    L->workers.emplace_back([L] { L->work(); });
  return L;
}

// File-backed variant: records live in `path` starting at `data_offset`
// (raw packed rows, the layout write_file_dataset emits); worker threads
// pread() them straight into batch slots — the disk analog of the
// reference's MultiprocessIterator feeding ImageNet from local storage.
void* pfl_create_file(const char* path, int64_t data_offset,
                      int64_t record_bytes, int64_t n_records,
                      int64_t batch_size, int n_slots, int n_threads) {
  if (record_bytes <= 0 || batch_size <= 0 || n_slots < 2 || n_threads < 1)
    return nullptr;
  int fd = open(path, O_RDONLY);
  if (fd < 0) return nullptr;
  auto* L = new Loader();
  L->data = nullptr;
  L->fd = fd;
  L->data_offset = data_offset;
  L->record_bytes = record_bytes;
  L->n_records = n_records;
  L->batch_size = batch_size;
  L->n_slots = n_slots;
  L->slots.resize(n_slots);
  for (auto& s : L->slots)
    s.buf.resize(static_cast<size_t>(batch_size * record_bytes));
  for (int i = 0; i < n_threads; ++i)
    L->workers.emplace_back([L] { L->work(); });
  return L;
}

// Abandon the current stream in O(1): no new claims, wait out in-flight
// fills, reset the ring.  Caller must have released any held slot.
int pfl_cancel(void* h) {
  auto* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->acquired >= 0) return -1;
  ++L->gen;           // invalidates every outstanding claim
  L->n_batches = 0;   // parks claim loops immediately
  L->next_build = 0;
  L->next_consume = 0;
  L->cv_slot_free.notify_all();  // wake gate-parked workers to drop claims
  while (L->filling > 0) {
    // Workers mid-copy finish into their slot but skip the publish (gen
    // mismatch); cv_batch_ready fires exactly on that finish.
    L->cv_batch_ready.wait(lk);
  }
  for (auto& s : L->slots) { s.batch = -1; s.consumed = true; }
  return 0;
}

// Define a new stream. Caller must have consumed the previous stream fully
// (next_consume == n_batches) — enforced by returning -1 on violation.
int pfl_set_order(void* h, const int64_t* idx, int64_t n_idx) {
  auto* L = static_cast<Loader*>(h);
  std::lock_guard<std::mutex> lk(L->mu);
  if (L->next_consume < L->n_batches || L->acquired >= 0) return -1;
  int64_t nb = n_idx / L->batch_size;
  L->order.assign(idx, idx + nb * L->batch_size);
  for (auto& s : L->slots) { s.batch = -1; s.consumed = true; }
  L->n_batches = nb;
  L->next_consume = 0;
  L->next_build = 0;
  L->cv_slot_free.notify_all();
  return 0;
}

// Blocks until the next in-order batch is assembled; returns its index and
// sets *out to the slot buffer, or returns -1 when the stream is done.
int64_t pfl_acquire(void* h, void** out) {
  auto* L = static_cast<Loader*>(h);
  std::unique_lock<std::mutex> lk(L->mu);
  if (L->acquired >= 0) return -2;  // release first
  if (L->next_consume >= L->n_batches) return -1;
  int64_t b = L->next_consume;
  Slot& slot = L->slots[b % L->n_slots];
  while (!L->stop && !L->io_error && slot.batch != b)
    L->cv_batch_ready.wait(lk);
  if (L->io_error) return -3;  // disk read failed; stream is poisoned
  if (L->stop) return -1;
  L->acquired = b % L->n_slots;
  *out = slot.buf.data();
  return b;
}

void pfl_release(void* h) {
  auto* L = static_cast<Loader*>(h);
  std::lock_guard<std::mutex> lk(L->mu);
  if (L->acquired < 0) return;
  Slot& slot = L->slots[L->acquired];
  slot.consumed = true;
  slot.batch = -1;
  L->acquired = -1;
  ++L->next_consume;
  L->cv_slot_free.notify_all();
}

void pfl_destroy(void* h) {
  auto* L = static_cast<Loader*>(h);
  {
    std::lock_guard<std::mutex> lk(L->mu);
    L->stop = true;
  }
  L->cv_slot_free.notify_all();
  L->cv_batch_ready.notify_all();
  for (auto& t : L->workers) t.join();
  if (L->fd >= 0) close(L->fd);
  delete L;
}

}  // extern "C"
