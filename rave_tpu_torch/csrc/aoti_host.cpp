// aoti_host: standalone C++ serving host for the port's exported steps.
//
// Port of native/pjrt_host.cpp.  There the exported artifact is StableHLO
// compiled by a PJRT plugin when the host starts; here it is an
// AOTInductor package (<prefix>.aoti.pt2, written by
// `python -m rave_tpu_torch.export.native`), the exported step already
// compiled for its device, loaded by libtorch's AOTIModelPackageLoader
// and run with no Python.
//
// Usage:
//   aoti_host <export_dir> [n_blocks] [key=value...]
//
// keys:
//   prefix=forward|convert|convert_pg  the step to serve (default forward)
//   device=cuda|cpu                    default cuda; the package must have
//                                      been compiled for the same device
//   x_in=<file>    raw float32 chunk input, n_blocks blocks of
//                  batch * chunk samples; without it the input is zeros
//   y_out=<file>   every block of the blocking loop's output, raw float32
//   carry_out=<file>  the caches after the blocking loop, raw, each in its
//                  manifest dtype, in manifest order
//
// Per audio block the step is pure over the manifest's call convention
//   (cache..., x, extra...) -> (y, cache...)
// (io_manifest.txt or <prefix>_manifest.txt: the cache count is the
// output count minus 1; the initial caches are cache_init.bin or
// <prefix>_cache_init.bin).  Every input and output shape the package
// reports (its metadata, then the outputs of the first call) is held
// against the manifest; the first that differs exits 1.  Inputs other
// than the chunk (the speaker embedding, the pitch feature) stay zeros.
// A manifest entry is float32 or bfloat16 (the caches of a step exported
// with compute_dtype=bfloat16, read from the raw little-endian bf16 of
// the cache file into bf16 inputs and carried as such), as
// native/pjrt_host.cpp takes them; any other dtype exits 1.  The chunk
// and the output are float32.
//
// On the card, once the caches are warm, one block (the step and the
// copy of its new caches into the static ones) is captured in a CUDA
// graph and replayed per block: the counterpart of one PJRT execution.
// A capture that fails exits 1; the host never falls back.
//
// TF32 is off for cuDNN and cuBLAS, as in the port's reference numbers.
//
// Loops, each from the initial caches over the same n_blocks blocks:
// one warm-up call, a pipelined loop (only the last block fetched), a
// blocking loop (every block's y copied to the host before the next
// block is submitted).  Prints one JSON line with blocks/s, the
// real-time factors, the blocking loop's p50/p80 block time and the
// seconds the package took to load.

#include <ATen/ATen.h>
#include <torch/csrc/inductor/aoti_package/model_package_loader.h>
#ifdef AOTI_HOST_CUDA
#include <ATen/cuda/CUDAGraph.h>
#include <c10/cuda/CUDAGuard.h>
#include <c10/cuda/CUDAStream.h>
#endif

#include <algorithm>
#include <chrono>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <exception>
#include <fstream>
#include <functional>
#include <memory>
#include <sstream>
#include <string>
#include <unordered_map>
#include <vector>

namespace {

struct TensorSpec {
  at::ScalarType dtype;
  size_t nbytes;
  std::vector<int64_t> dims;
};

[[noreturn]] void Fail(const std::string& msg) {
  std::fprintf(stderr, "aoti_host: %s\n", msg.c_str());
  std::exit(1);
}

std::string ReadFile(const std::string& path) {
  std::ifstream f(path, std::ios::binary);
  if (!f) Fail("cannot open " + path);
  std::ostringstream ss;
  ss << f.rdbuf();
  return ss.str();
}

std::string ShapeStr(const std::vector<int64_t>& dims) {
  std::string s = "(";
  for (size_t i = 0; i < dims.size(); ++i)
    s += (i ? ", " : "") + std::to_string(dims[i]);
  return s + ")";
}

// "1,16,32;1,2048,1" (the package metadata written by compile_package)
std::vector<std::vector<int64_t>> ParseShapes(const std::string& text) {
  std::vector<std::vector<int64_t>> shapes;
  std::stringstream all(text);
  std::string one;
  while (std::getline(all, one, ';')) {
    std::vector<int64_t> dims;
    std::stringstream ds(one);
    std::string d;
    while (std::getline(ds, d, ',')) dims.push_back(std::stoll(d));
    shapes.push_back(std::move(dims));
  }
  return shapes;
}

void CheckShapes(const std::vector<TensorSpec>& specs,
                 const std::vector<std::vector<int64_t>>& got,
                 const char* kind, const std::string& where) {
  if (got.size() != specs.size())
    Fail(std::string(where) + " has " + std::to_string(got.size()) + " " +
         kind + "puts, the manifest " + std::to_string(specs.size()));
  for (size_t i = 0; i < specs.size(); ++i)
    if (got[i] != specs[i].dims)
      Fail(where + " " + kind + "put " + std::to_string(i) + " has shape " +
           ShapeStr(got[i]) + ", the manifest " + ShapeStr(specs[i].dims));
}

double Percentile(std::vector<double> v, double q) {
  std::sort(v.begin(), v.end());
  const double pos = q * (v.size() - 1);
  const size_t lo = static_cast<size_t>(pos);
  const size_t hi = std::min(lo + 1, v.size() - 1);
  return v[lo] + (v[hi] - v[lo]) * (pos - lo);
}

double Seconds(std::chrono::steady_clock::time_point t0) {
  return std::chrono::duration<double>(std::chrono::steady_clock::now() - t0)
      .count();
}

}  // namespace

int main(int argc, char** argv) {
  if (argc < 2) {
    std::fprintf(stderr,
                 "usage: %s <export_dir> [n_blocks] [prefix=forward] "
                 "[device=cuda|cpu] [x_in=file] [y_out=file] "
                 "[carry_out=file]\n",
                 argv[0]);
    return 1;
  }
  const std::string dir = argv[1];
  const int n_blocks = argc > 2 ? std::atoi(argv[2]) : 100;
  if (n_blocks < 1) Fail("n_blocks must be at least 1");
  std::string prefix = "forward", device = "cuda", x_in, y_out, carry_out;
  for (int i = 3; i < argc; ++i) {
    const char* eq = std::strchr(argv[i], '=');
    if (!eq) Fail(std::string("expected key=value, got ") + argv[i]);
    const std::string key(argv[i], eq - argv[i]), val(eq + 1);
    if (key == "prefix") prefix = val;
    else if (key == "device") device = val;
    else if (key == "x_in") x_in = val;
    else if (key == "y_out") y_out = val;
    else if (key == "carry_out") carry_out = val;
    else Fail("unknown key " + key);
  }
  if (device != "cuda" && device != "cpu") Fail("device must be cuda or cpu");
#ifndef AOTI_HOST_CUDA
  if (device == "cuda") Fail("this host was built without CUDA");
#endif
  at::globalContext().setAllowTF32CuDNN(false);
  at::globalContext().setAllowTF32CuBLAS(false);
  const bool first = prefix == "forward";
  const std::string manifest_path =
      dir + (first ? "/io_manifest.txt" : "/" + prefix + "_manifest.txt");
  const std::string cache_path =
      dir + (first ? "/cache_init.bin" : "/" + prefix + "_cache_init.bin");
  const std::string package_path = dir + "/" + prefix + ".aoti.pt2";

  // ---- manifest --------------------------------------------------------
  std::istringstream mf(ReadFile(manifest_path));
  int64_t chunk = 0, sample_rate = 0, batch = 0;
  std::vector<TensorSpec> in_specs, out_specs;
  std::string line;
  while (std::getline(mf, line)) {
    std::istringstream ls(line);
    std::string kind;
    ls >> kind;
    if (kind == "meta") {
      ls >> chunk >> sample_rate >> batch;
      continue;
    }
    std::string dtype;
    size_t nbytes = 0, ndims = 0;
    ls >> dtype >> nbytes >> ndims;
    at::ScalarType type;
    if (dtype == "float32") type = at::kFloat;
    else if (dtype == "bfloat16") type = at::kBFloat16;
    else Fail("unsupported dtype in manifest: " + dtype);
    TensorSpec spec{type, nbytes, std::vector<int64_t>(ndims)};
    for (size_t i = 0; i < ndims; ++i) ls >> spec.dims[i];
    if (!ls || (kind != "in" && kind != "out"))
      Fail("bad manifest line: " + line);
    (kind == "in" ? in_specs : out_specs).push_back(std::move(spec));
  }
  if (chunk <= 0 || sample_rate <= 0 || out_specs.empty())
    Fail(manifest_path + ": no meta line or no outputs");
  // call convention: (cache..., extra...) -> (y, cache...)
  const size_t num_args = in_specs.size();
  const size_t num_cache = out_specs.size() - 1;
  if (num_cache >= num_args)
    Fail("manifest: as many cache outputs as inputs (no chunk input)");
  const TensorSpec& x_spec = in_specs[num_cache];
  if (x_spec.dtype != at::kFloat || out_specs[0].dtype != at::kFloat)
    Fail("manifest: the chunk and the output must be float32");
  std::fprintf(stderr,
               "model: step=%s chunk=%lld sr=%lld batch=%lld "
               "cache_leaves=%zu extra_inputs=%zu device=%s\n",
               prefix.c_str(), static_cast<long long>(chunk),
               static_cast<long long>(sample_rate),
               static_cast<long long>(batch), num_cache,
               num_args - num_cache, device.c_str());

  // ---- the package -----------------------------------------------------
  if (!std::ifstream(package_path))
    Fail("cannot open " + package_path +
         " (compile it with python -m rave_tpu_torch.export.native)");
  const auto t_load0 = std::chrono::steady_clock::now();
  std::unique_ptr<torch::inductor::AOTIModelPackageLoader> loader;
  std::unordered_map<std::string, std::string> meta;
  try {
    // single-threaded runner: no CUDA events, so the step can be captured
    loader = std::make_unique<torch::inductor::AOTIModelPackageLoader>(
        package_path, "model", /*run_single_threaded=*/true);
    meta = loader->get_metadata();
  } catch (const std::exception& e) {
    Fail(std::string("loading ") + package_path + " failed: " + e.what());
  }
  {
    const auto dev = meta.find("AOTI_DEVICE_KEY");
    if (dev == meta.end() || dev->second != device)
      Fail(package_path + " was compiled for " +
           (dev == meta.end() ? std::string("no device") : dev->second) +
           ", not for device=" + device);
    for (const char* key : {"rave_in_shapes", "rave_out_shapes"})
      if (!meta.count(key))
        Fail(package_path + " has no " + key +
             " metadata (compile it with python -m "
             "rave_tpu_torch.export.native)");
    CheckShapes(in_specs, ParseShapes(meta["rave_in_shapes"]), "in",
                package_path);
    CheckShapes(out_specs, ParseShapes(meta["rave_out_shapes"]), "out",
                package_path);
  }
  for (size_t i = 0; i < num_cache; ++i)
    if (in_specs[i].dims != out_specs[i + 1].dims ||
        in_specs[i].dtype != out_specs[i + 1].dtype)
      Fail("manifest: cache " + std::to_string(i) + " goes in as " +
           ShapeStr(in_specs[i].dims) + " " +
           c10::toString(in_specs[i].dtype) + " and comes out as " +
           ShapeStr(out_specs[i + 1].dims) + " " +
           c10::toString(out_specs[i + 1].dtype));
  const double loaded_s = Seconds(t_load0);

  // ---- inputs ----------------------------------------------------------
  const at::Device dev(device == "cuda" ? at::kCUDA : at::kCPU, 0);
  const auto f32 = at::TensorOptions().dtype(at::kFloat);
  std::string cache_init = ReadFile(cache_path);
  size_t cache_bytes = 0;
  for (size_t i = 0; i < num_cache; ++i) cache_bytes += in_specs[i].nbytes;
  if (cache_bytes != cache_init.size())
    Fail(cache_path + " holds " + std::to_string(cache_init.size()) +
         " bytes, the manifest's caches " + std::to_string(cache_bytes));
  std::vector<at::Tensor> init(num_cache);
  for (size_t i = 0, off = 0; i < num_cache; off += in_specs[i].nbytes, ++i)
    init[i] = at::from_blob(cache_init.data() + off, in_specs[i].dims,
                            at::TensorOptions().dtype(in_specs[i].dtype))
                  .to(dev, /*non_blocking=*/false, /*copy=*/true);
  // the chunk of every block, on the host (pinned on the card, so that a
  // block's copy is asynchronous and each block has its own source)
  const int64_t x_numel = static_cast<int64_t>(x_spec.nbytes / 4);
  at::Tensor x_host = at::zeros({n_blocks, x_numel},
                                f32.pinned_memory(device == "cuda"));
  if (!x_in.empty()) {
    std::string raw = ReadFile(x_in);
    if (raw.size() < x_spec.nbytes * n_blocks)
      Fail(x_in + " holds " + std::to_string(raw.size()) + " bytes, " +
           std::to_string(n_blocks) + " blocks need " +
           std::to_string(x_spec.nbytes * n_blocks));
    std::memcpy(x_host.data_ptr<float>(), raw.data(),
                x_spec.nbytes * n_blocks);
  }
  std::vector<at::Tensor> args(num_args);
  for (size_t i = 0; i < num_args; ++i)
    args[i] = i < num_cache
                  ? init[i].clone()
                  : at::zeros(in_specs[i].dims,
                              at::TensorOptions()
                                  .dtype(in_specs[i].dtype)
                                  .device(dev));
  at::Tensor& x = args[num_cache];
  auto reset = [&]() {
    for (size_t i = 0; i < num_cache; ++i) args[i].copy_(init[i]);
  };
  auto fill = [&](int b) {
    x.copy_(x_host[b].view(x_spec.dims), /*non_blocking=*/true);
  };

#ifdef AOTI_HOST_CUDA
  // every call, copy and capture on one side stream (a capture needs a
  // stream other than the default one)
  std::unique_ptr<c10::cuda::CUDAStreamGuard> guard;
  std::unique_ptr<at::cuda::CUDAGraph> graph;
  void* stream = nullptr;
  if (device == "cuda") {
    auto side = c10::cuda::getStreamFromPool(false, 0);
    guard = std::make_unique<c10::cuda::CUDAStreamGuard>(side);
    stream = side.stream();
  }
#else
  void* stream = nullptr;
#endif
  // warm-up: the first call (kernel loading, cuFFT plans), its output
  // shapes held against the manifest, its caches carried
  std::vector<at::Tensor> outs;
  try {
    fill(0);
    outs = loader->run(args, stream);
  } catch (const std::exception& e) {
    Fail(std::string("the first call failed: ") + e.what());
  }
  std::vector<std::vector<int64_t>> shapes;
  for (const auto& t : outs) shapes.push_back(t.sizes().vec());
  CheckShapes(out_specs, shapes, "out", "the step's");
  for (size_t i = 0; i < num_cache; ++i) args[i].copy_(outs[i + 1]);
  at::Tensor y = outs[0];

  // one block: fill the chunk, run the step, carry the caches.  The new
  // caches are copied into the contiguous inputs: an output may be a
  // strided view (a slice of a longer buffer), and the compiled step
  // reads its inputs with the strides it was exported with.
  std::function<void(int)> block;
  if (device == "cpu") {
    block = [&](int b) {
      fill(b);
      auto o = loader->run(args, nullptr);
      for (size_t i = 0; i < num_cache; ++i) args[i].copy_(o[i + 1]);
      y = o[0];
    };
  }
#ifdef AOTI_HOST_CUDA
  else {
    try {
      graph = std::make_unique<at::cuda::CUDAGraph>();
      graph->capture_begin();
      auto o = loader->run(args, stream);
      for (size_t i = 0; i < num_cache; ++i) args[i].copy_(o[i + 1]);
      y = o[0];
      graph->capture_end();
    } catch (const std::exception& e) {
      Fail(std::string("capturing the step in a CUDA graph failed: ") +
           e.what());
    }
    block = [&](int b) {
      fill(b);
      graph->replay();
    };
  }
#endif
  auto sync = [&]() {
#ifdef AOTI_HOST_CUDA
    if (device == "cuda") c10::cuda::getCurrentCUDAStream().synchronize();
#endif
  };
  std::vector<float> y_host(out_specs[0].nbytes / 4);
  auto fetch = [&]() {
    at::Tensor dst = at::from_blob(y_host.data(), out_specs[0].dims, f32);
    dst.copy_(y);  // synchronous: the block is on the host after it
  };

  // 1) pipelined: every block submitted as soon as the host can, only the
  //    last one fetched
  reset();
  sync();
  auto t0 = std::chrono::steady_clock::now();
  for (int b = 0; b < n_blocks; ++b) block(b);
  fetch();
  const double dt_pipe = Seconds(t0);

  // 2) blocking: every block's audio back on the host before the next
  //    block is submitted (the DAW-host pattern)
  std::FILE* yf = nullptr;
  if (!y_out.empty() && !(yf = std::fopen(y_out.c_str(), "wb")))
    Fail("cannot write " + y_out);
  std::vector<double> block_ms(n_blocks);
  reset();
  sync();
  t0 = std::chrono::steady_clock::now();
  for (int b = 0; b < n_blocks; ++b) {
    const auto tb = std::chrono::steady_clock::now();
    block(b);
    fetch();
    block_ms[b] = Seconds(tb) * 1e3;
    if (yf) {
      // outside the block's time, inside the loop's (small next to a block)
      if (std::fwrite(y_host.data(), 4, y_host.size(), yf) != y_host.size())
        Fail("cannot write " + y_out);
    }
  }
  const double dt = Seconds(t0);
  if (yf) std::fclose(yf);
  if (!carry_out.empty()) {
    std::FILE* cf = std::fopen(carry_out.c_str(), "wb");
    if (!cf) Fail("cannot write " + carry_out);
    for (size_t i = 0; i < num_cache; ++i) {
      at::Tensor c = args[i].cpu().contiguous();
      if (std::fwrite(c.data_ptr(), c.element_size(), c.numel(), cf) !=
          static_cast<size_t>(c.numel()))
        Fail("cannot write " + carry_out);
    }
    std::fclose(cf);
  }

  const double audio_s = static_cast<double>(n_blocks) *
                         static_cast<double>(chunk) /
                         static_cast<double>(sample_rate);
  double checksum = 0;
  for (float v : y_host) checksum += v;
  std::printf(
      "{\"blocks\": %d, \"pipelined_blocks_per_s\": %.6f, "
      "\"pipelined_rtf\": %.8f, \"blocking_rtf\": %.8f, "
      "\"checksum\": %.6f, \"block_ms_p50\": %.6f, \"block_ms_p80\": %.6f, "
      "\"loaded_s\": %.6f, \"prefix\": \"%s\", \"device\": \"%s\", "
      "\"cuda_graph\": %s}\n",
      n_blocks, n_blocks / dt_pipe, dt_pipe / audio_s, dt / audio_s, checksum,
      Percentile(block_ms, 0.5), Percentile(block_ms, 0.8), loaded_s,
      prefix.c_str(), device.c_str(), device == "cuda" ? "true" : "false");
  return 0;
}
