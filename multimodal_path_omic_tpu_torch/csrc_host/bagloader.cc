// bagloader — host bag loader of the PyTorch port: mmap'd .npy reads and a
// threaded fill of pinned host rows.
//
// It indexes a directory of per-slide `.npy` float32 [M, D] arrays (the
// recommended bag format, data/bags.py), mmaps them, and copies bags with a
// thread pool: one memcpy per bag straight from the page cache into the
// caller's buffer. The store functions fill whole padded batches; the
// pipeline below fills a ring of slots with the bags' own rows, packed, which
// is what the port's Stager copies to the device (the device pads them).
//
// C ABI (consumed via ctypes from multimodal_path_omic_tpu_torch/data/native.py):
//   bl_open(dir)                      -> store handle (0 on failure)
//   bl_count(h)                       -> number of indexed slides
//   bl_lookup(h, name)                -> slide id (-1 if missing)
//   bl_length(h, id) / bl_dim(h, id)  -> M / D
//   bl_load_batch(h, ids, n, bucket, dim, wsi_out, mask_out, threads) -> 0/err
//   bl_close(h)

#include <atomic>
#include <cstdint>
#include <cstring>
#include <fcntl.h>
#include <string>
#include <sys/mman.h>
#include <sys/stat.h>
#include <thread>
#include <unistd.h>
#include <unordered_map>
#include <vector>
#include <dirent.h>

namespace {

struct Bag {
  std::string path;
  int64_t rows = 0;
  int64_t cols = 0;
  int64_t data_offset = 0;  // byte offset of payload in the file
  int64_t file_size = 0;
};

struct Store {
  std::vector<Bag> bags;
  std::unordered_map<std::string, int64_t> index;
};

// Parse a .npy v1/v2 header; only little-endian float32, C-order, 2-D.
// Requires bag->file_size to be set: the header-declared payload must fit
// inside the file, or a truncated/corrupt .npy would let fill paths memcpy
// past the mmapped region (SIGBUS) or copy garbage.
bool parse_npy_header(int fd, Bag* bag) {
  unsigned char magic[8];
  if (pread(fd, magic, 8, 0) != 8) return false;
  if (memcmp(magic, "\x93NUMPY", 6) != 0) return false;
  int major = magic[6];
  uint32_t header_len = 0;
  int64_t header_start;
  if (major == 1) {
    unsigned char l[2];
    if (pread(fd, l, 2, 8) != 2) return false;
    header_len = l[0] | (l[1] << 8);
    header_start = 10;
  } else {
    unsigned char l[4];
    if (pread(fd, l, 4, 8) != 4) return false;
    header_len = l[0] | (l[1] << 8) | (l[2] << 16) | (uint32_t(l[3]) << 24);
    header_start = 12;
  }
  std::string header(header_len, '\0');
  if (pread(fd, header.data(), header_len, header_start) != (ssize_t)header_len)
    return false;
  if (header.find("'<f4'") == std::string::npos) return false;
  if (header.find("'fortran_order': False") == std::string::npos) return false;
  auto pos = header.find("'shape': (");
  if (pos == std::string::npos) return false;
  pos += 10;
  char* end = nullptr;
  long rows = strtol(header.c_str() + pos, &end, 10);
  while (*end == ',' || *end == ' ') ++end;
  long cols = strtol(end, &end, 10);
  if (rows <= 0 || cols <= 0) return false;
  bag->rows = rows;
  bag->cols = cols;
  bag->data_offset = header_start + header_len;
  // Reject files whose payload does not match the declared shape.
  int64_t payload = (int64_t)rows * cols * (int64_t)sizeof(float);
  if (bag->data_offset + payload > bag->file_size) return false;
  return true;
}

bool ends_with(const std::string& s, const std::string& suffix) {
  return s.size() >= suffix.size() &&
         s.compare(s.size() - suffix.size(), suffix.size(), suffix) == 0;
}

}  // namespace

extern "C" {

void* bl_open(const char* dir) {
  DIR* d = opendir(dir);
  if (!d) return nullptr;
  auto* store = new Store();
  std::string base(dir);
  if (!base.empty() && base.back() != '/') base += '/';
  struct dirent* entry;
  while ((entry = readdir(d)) != nullptr) {
    std::string name(entry->d_name);
    if (!ends_with(name, ".npy")) continue;
    Bag bag;
    bag.path = base + name;
    int fd = open(bag.path.c_str(), O_RDONLY);
    if (fd < 0) continue;
    struct stat st;
    if (fstat(fd, &st) == 0 && (bag.file_size = st.st_size, true) &&
        parse_npy_header(fd, &bag)) {
      std::string stem = name.substr(0, name.size() - 4);
      store->index[stem] = (int64_t)store->bags.size();
      store->bags.push_back(std::move(bag));
    }
    close(fd);
  }
  closedir(d);
  return store;
}

int64_t bl_count(void* handle) {
  return handle ? (int64_t)((Store*)handle)->bags.size() : -1;
}

int64_t bl_lookup(void* handle, const char* name) {
  auto* store = (Store*)handle;
  auto it = store->index.find(name);
  return it == store->index.end() ? -1 : it->second;
}

int64_t bl_length(void* handle, int64_t id) {
  auto* store = (Store*)handle;
  if (id < 0 || id >= (int64_t)store->bags.size()) return -1;
  return store->bags[id].rows;
}

int64_t bl_dim(void* handle, int64_t id) {
  auto* store = (Store*)handle;
  if (id < 0 || id >= (int64_t)store->bags.size()) return -1;
  return store->bags[id].cols;
}

// Fill wsi_out [n, bucket, dim] (f32, zero-padded) and mask_out [n, bucket]
// (uint8) from the bags named by ids[0..n). Rows beyond `bucket` are
// truncated (callers bucket correctly so this does not happen in practice).
int bl_load_batch(void* handle, const int64_t* ids, int64_t n, int64_t bucket,
                  int64_t dim, float* wsi_out, uint8_t* mask_out,
                  int threads) {
  auto* store = (Store*)handle;
  std::atomic<int64_t> next(0);
  std::atomic<int> err(0);

  auto worker = [&]() {
    for (;;) {
      int64_t i = next.fetch_add(1);
      if (i >= n) return;
      int64_t id = ids[i];
      float* dst = wsi_out + i * bucket * dim;
      uint8_t* mdst = mask_out + i * bucket;
      if (id < 0 || id >= (int64_t)store->bags.size()) {
        err.store(2);
        continue;
      }
      const Bag& bag = store->bags[id];
      if (bag.cols != dim) {
        err.store(3);
        continue;
      }
      int64_t rows = bag.rows < bucket ? bag.rows : bucket;
      int fd = open(bag.path.c_str(), O_RDONLY);
      if (fd < 0) {
        err.store(4);
        continue;
      }
      void* mapped =
          mmap(nullptr, bag.file_size, PROT_READ, MAP_PRIVATE, fd, 0);
      close(fd);
      if (mapped == MAP_FAILED) {
        err.store(5);
        continue;
      }
      const char* payload = (const char*)mapped + bag.data_offset;
      memcpy(dst, payload, (size_t)rows * dim * sizeof(float));
      if (rows < bucket)
        memset(dst + rows * dim, 0, (size_t)(bucket - rows) * dim * sizeof(float));
      memset(mdst, 1, (size_t)rows);
      if (rows < bucket) memset(mdst + rows, 0, (size_t)(bucket - rows));
      munmap(mapped, bag.file_size);
    }
  };

  int n_threads = threads > 0 ? threads : 4;
  if (n_threads > n) n_threads = (int)n;
  std::vector<std::thread> pool;
  for (int t = 0; t < n_threads; ++t) pool.emplace_back(worker);
  for (auto& t : pool) t.join();
  return err.load();
}

void bl_close(void* handle) { delete (Store*)handle; }

}  // extern "C"

// ============================================================================
// Pipelined row executor: a ring of caller-allocated slot buffers (pinned host
// memory on a GPU host) filled by a worker pool according to a precomputed
// epoch plan. The host copies ready slots to the device while workers prepare
// the next batches; no Python thread in the fill path.
//
//   bl_pipe_create(store, task_ids, task_src, task_rows, task_dst,
//                  batch_offsets, n_batches, dim, slot_rows, slots, n_slots,
//                  threads) -> pipe handle
//   bl_pipe_next(pipe)              -> batch index now ready (in plan order),
//                                      or -1 when the plan is exhausted
//   bl_pipe_release(pipe, batch)    -> recycle that batch's slot
//   bl_pipe_error(pipe)             -> first fill error code (0: none)
//   bl_pipe_destroy(pipe)
//
// A task copies rows [src, src + rows) of bag `id` to row `dst` of its batch's
// slot: a batch's bags land packed, one after another, with no padding. Slot
// buffers are f32 [n_slots, slot_rows, dim], owned by the caller; batch b
// lands in slot b % n_slots, and its slot is refilled only after the caller
// released b (the caller releases once the slot's copy to the device is done).

#include <condition_variable>
#include <memory>
#include <mutex>

namespace {

struct Pipe {
  Store* store = nullptr;
  const int64_t* task_ids = nullptr;
  const int64_t* task_src = nullptr;
  const int64_t* task_rows = nullptr;
  const int64_t* task_dst = nullptr;
  const int64_t* batch_offsets = nullptr;  // n_batches + 1, into the tasks
  int64_t n_batches = 0;
  int64_t dim = 0;
  int64_t slot_rows = 0;
  float* slots = nullptr;
  int64_t n_slots = 0;
  int64_t n_tasks = 0;

  std::mutex mu;
  std::condition_variable cv;
  std::vector<int> slot_state;  // 0 free, 2 filling, 1 ready (slot_batch[i])
  std::vector<int64_t> slot_batch;
  // slot s must next be acquired by this batch: out-of-order acquisition
  // would deadlock the in-order consumer
  std::vector<int64_t> slot_next_fill;
  std::vector<int> batch_state;  // 0 slot not yet acquired, 1 acquired
  std::unique_ptr<std::atomic<int64_t>[]> remaining;
  std::vector<int64_t> task_batch;
  std::atomic<int64_t> next_task{0};
  int64_t next_to_consume = 0;
  std::atomic<int> error{0};
  bool stopping = false;
  std::vector<std::thread> workers;
};

void fill_task(Pipe* p, int64_t b, int64_t t) {
  int64_t id = p->task_ids[t];
  int64_t src = p->task_src[t];
  int64_t rows = p->task_rows[t];
  int64_t dst_row = p->task_dst[t];
  if (rows == 0) return;
  if (id < 0 || id >= (int64_t)p->store->bags.size()) { p->error.store(2); return; }
  const Bag& bag = p->store->bags[id];
  if (bag.cols != p->dim) { p->error.store(3); return; }
  if (src < 0 || rows < 0 || src + rows > bag.rows || dst_row + rows > p->slot_rows) {
    p->error.store(6);
    return;
  }
  float* dst = p->slots + ((b % p->n_slots) * p->slot_rows + dst_row) * p->dim;
  int fd = open(bag.path.c_str(), O_RDONLY);
  if (fd < 0) { p->error.store(4); return; }
  void* mapped = mmap(nullptr, bag.file_size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (mapped == MAP_FAILED) { p->error.store(5); return; }
  memcpy(dst, (const char*)mapped + bag.data_offset + src * p->dim * (int64_t)sizeof(float),
         (size_t)rows * p->dim * sizeof(float));
  munmap(mapped, bag.file_size);
}

// Work-stealing worker: tasks (bags) are claimed in flat order, so several
// workers cooperate on one batch, and at most n_slots consecutive batches are
// in flight.
void pipe_worker(Pipe* p) {
  for (;;) {
    int64_t t = p->next_task.fetch_add(1);
    if (t >= p->n_tasks) return;
    int64_t b = p->task_batch[t];
    int64_t slot = b % p->n_slots;
    {
      std::unique_lock<std::mutex> lock(p->mu);
      p->cv.wait(lock, [&] {
        return p->stopping || p->batch_state[b] == 1 ||
               (p->batch_state[b] == 0 && p->slot_state[slot] == 0 &&
                p->slot_next_fill[slot] == b);
      });
      if (p->stopping) return;
      if (p->batch_state[b] == 0) {  // first worker of this batch: claim the slot
        p->slot_state[slot] = 2;
        p->slot_next_fill[slot] = b + p->n_slots;
        p->batch_state[b] = 1;
        p->cv.notify_all();
      }
    }
    fill_task(p, b, t);
    if (p->remaining[b].fetch_sub(1) == 1) {  // the batch's last bag
      {
        std::lock_guard<std::mutex> lock(p->mu);
        p->slot_state[slot] = 1;
        p->slot_batch[slot] = b;
      }
      p->cv.notify_all();
    }
  }
}

}  // namespace

extern "C" {

void* bl_pipe_create(void* store, const int64_t* task_ids, const int64_t* task_src,
                     const int64_t* task_rows, const int64_t* task_dst,
                     const int64_t* batch_offsets, int64_t n_batches, int64_t dim,
                     int64_t slot_rows, float* slots, int64_t n_slots, int threads) {
  auto* p = new Pipe();
  p->store = (Store*)store;
  p->task_ids = task_ids;
  p->task_src = task_src;
  p->task_rows = task_rows;
  p->task_dst = task_dst;
  p->batch_offsets = batch_offsets;
  p->n_batches = n_batches;
  p->dim = dim;
  p->slot_rows = slot_rows;
  p->slots = slots;
  p->n_slots = n_slots;
  p->slot_state.assign(n_slots, 0);
  p->slot_batch.assign(n_slots, -1);
  p->slot_next_fill.resize(n_slots);
  for (int64_t i = 0; i < n_slots; ++i) p->slot_next_fill[i] = i;
  p->batch_state.assign(n_batches, 0);
  p->n_tasks = batch_offsets[n_batches];
  p->remaining.reset(new std::atomic<int64_t>[n_batches]);
  p->task_batch.resize(p->n_tasks);
  for (int64_t b = 0; b < n_batches; ++b) {
    p->remaining[b].store(batch_offsets[b + 1] - batch_offsets[b]);
    for (int64_t t = batch_offsets[b]; t < batch_offsets[b + 1]; ++t) p->task_batch[t] = b;
  }
  // a batch without a task is ready as soon as its slot is free
  for (int64_t b = 0; b < n_batches; ++b)
    if (batch_offsets[b + 1] == batch_offsets[b]) p->remaining[b].store(0);
  int n_threads = threads > 0 ? threads : 2;
  for (int t = 0; t < n_threads; ++t) p->workers.emplace_back(pipe_worker, p);
  return p;
}

// Blocks until the next batch (in plan order) is ready; returns its index or
// -1 when the plan is exhausted. Check bl_pipe_error afterwards.
int64_t bl_pipe_next(void* pipe) {
  auto* p = (Pipe*)pipe;
  if (p->next_to_consume >= p->n_batches) return -1;
  int64_t b = p->next_to_consume++;
  int64_t slot = b % p->n_slots;
  std::unique_lock<std::mutex> lock(p->mu);
  if (p->remaining[b].load() == 0 && p->batch_state[b] == 0) {
    // an empty batch: take its slot in turn, nothing to fill
    p->cv.wait(lock, [&] { return p->slot_state[slot] == 0 && p->slot_next_fill[slot] == b; });
    p->slot_next_fill[slot] = b + p->n_slots;
    p->batch_state[b] = 1;
    p->slot_state[slot] = 1;
    p->slot_batch[slot] = b;
    p->cv.notify_all();
    return b;
  }
  p->cv.wait(lock, [&] { return p->slot_state[slot] == 1 && p->slot_batch[slot] == b; });
  return b;
}

void bl_pipe_release(void* pipe, int64_t batch) {
  auto* p = (Pipe*)pipe;
  int64_t slot = batch % p->n_slots;
  {
    std::lock_guard<std::mutex> lock(p->mu);
    p->slot_state[slot] = 0;
    p->slot_batch[slot] = -1;
  }
  p->cv.notify_all();
}

int bl_pipe_error(void* pipe) { return ((Pipe*)pipe)->error.load(); }

void bl_pipe_destroy(void* pipe) {
  auto* p = (Pipe*)pipe;
  {
    std::lock_guard<std::mutex> lock(p->mu);
    p->stopping = true;
    p->next_task.store(p->n_tasks);
  }
  p->cv.notify_all();
  for (auto& t : p->workers) t.join();
  delete p;
}

}  // extern "C"
