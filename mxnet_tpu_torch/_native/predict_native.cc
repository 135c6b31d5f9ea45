// C-callable edge inference runtime (reference: src/c_api/c_predict_api.cc
// :: MXPredCreate/SetInput/Forward/GetOutput + amalgamation/), the port's
// copy of mxnet_tpu/_native/predict_native.cc, code unchanged.
//
// The framework exports a standard ONNX artifact (mx.onnx.export_model,
// self-contained protobuf); this runtime is a dependency-free C++17
// interpreter for the exported op set, built as one shared library with a
// flat C ABI -- no Python, no protobuf library, no BLAS.  The wire parsing
// below implements the protobuf subset ONNX uses (varints +
// length-delimited submessages) directly.
//
// It runs on the host by design: CPU-side edge serving and the C ABI
// surface; the card's path is the framework's own.

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <vector>

namespace {

thread_local std::string g_last_error;

struct Tensor {
  std::vector<int64_t> shape;
  std::vector<float> data;
  int64_t numel() const {
    int64_t n = 1;
    for (auto d : shape) n *= d;
    return n;
  }
};

// ---------------------------------------------------------------------
// protobuf wire reader
// ---------------------------------------------------------------------

struct Reader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  uint64_t varint() {
    uint64_t v = 0;
    int shift = 0;
    while (p < end) {
      uint8_t b = *p++;
      v |= uint64_t(b & 0x7F) << shift;
      if (!(b & 0x80)) return v;
      shift += 7;
      if (shift > 70) break;
    }
    ok = false;
    return 0;
  }

  bool next(uint32_t* field, uint32_t* wire, const uint8_t** payload,
            uint64_t* len) {
    if (p >= end || !ok) return false;
    uint64_t key = varint();
    if (!ok) return false;
    *field = uint32_t(key >> 3);
    *wire = uint32_t(key & 7);
    switch (*wire) {
      case 0:
        *len = varint();  // value itself
        *payload = nullptr;
        return ok;
      case 1:
        if (end - p < 8) return ok = false;
        *payload = p;
        *len = 8;
        p += 8;
        return true;
      case 2: {
        uint64_t n = varint();
        if (!ok || uint64_t(end - p) < n) return ok = false;
        *payload = p;
        *len = n;
        p += n;
        return true;
      }
      case 5:
        if (end - p < 4) return ok = false;
        *payload = p;
        *len = 4;
        p += 4;
        return true;
      default:
        return ok = false;
    }
  }
};

struct Attr {
  int64_t i = 0;
  float f = 0.f;
  std::string s;
  std::vector<int64_t> ints;
  std::vector<float> floats;
};

struct Node {
  std::string op;
  std::vector<std::string> inputs;
  std::vector<std::string> outputs;
  std::map<std::string, Attr> attrs;
};

struct Graph {
  std::vector<Node> nodes;
  std::map<std::string, Tensor> initializers;
  std::vector<std::string> inputs;   // non-initializer graph inputs
  std::vector<std::string> outputs;
};

std::string str_of(const uint8_t* p, uint64_t n) {
  return std::string(reinterpret_cast<const char*>(p), size_t(n));
}

bool parse_tensor(const uint8_t* buf, uint64_t len, std::string* name,
                  Tensor* t) {
  Reader r{buf, buf + len};
  uint32_t field, wire;
  const uint8_t* pl;
  uint64_t n;
  int32_t dtype = 1;
  const uint8_t* raw = nullptr;
  uint64_t rawlen = 0;
  std::vector<float> fdata;
  std::vector<int64_t> idata;
  while (r.next(&field, &wire, &pl, &n)) {
    switch (field) {
      case 1:  // dims (proto3 serializers emit repeated int64 packed)
        if (wire == 0) {
          t->shape.push_back(int64_t(n));
        } else if (wire == 2) {
          Reader rr{pl, pl + n};
          while (rr.p < rr.end && rr.ok)
            t->shape.push_back(int64_t(rr.varint()));
        }
        break;
      case 2:
        if (wire == 0) dtype = int32_t(n);
        break;
      case 4:  // float_data (packed or not)
        if (wire == 2)
          for (uint64_t i = 0; i + 4 <= n; i += 4) {
            float f;
            memcpy(&f, pl + i, 4);
            fdata.push_back(f);
          }
        else if (wire == 5) {
          float f;
          memcpy(&f, pl, 4);
          fdata.push_back(f);
        }
        break;
      case 7:  // int64_data
        if (wire == 0)
          idata.push_back(int64_t(n));
        else if (wire == 2) {
          Reader rr{pl, pl + n};
          while (rr.p < rr.end && rr.ok) idata.push_back(int64_t(rr.varint()));
        }
        break;
      case 8:
        if (wire == 2) *name = str_of(pl, n);
        break;
      case 9:
        if (wire == 2) {
          raw = pl;
          rawlen = n;
        }
        break;
      default:
        break;
    }
  }
  if (!r.ok) return false;
  int64_t numel = 1;
  for (auto d : t->shape) numel *= d;
  t->data.resize(size_t(numel));
  if (raw) {
    switch (dtype) {
      case 1:  // FLOAT
        if (rawlen < uint64_t(numel) * 4) return false;
        memcpy(t->data.data(), raw, size_t(numel) * 4);
        break;
      case 7: {  // INT64
        if (rawlen < uint64_t(numel) * 8) return false;
        for (int64_t i = 0; i < numel; ++i) {
          int64_t v;
          memcpy(&v, raw + i * 8, 8);
          t->data[size_t(i)] = float(v);
        }
        break;
      }
      case 6: {  // INT32
        if (rawlen < uint64_t(numel) * 4) return false;
        for (int64_t i = 0; i < numel; ++i) {
          int32_t v;
          memcpy(&v, raw + i * 4, 4);
          t->data[size_t(i)] = float(v);
        }
        break;
      }
      default:
        g_last_error = "unsupported tensor dtype " + std::to_string(dtype);
        return false;
    }
  } else if (!fdata.empty()) {
    if (int64_t(fdata.size()) < numel) return false;
    std::copy(fdata.begin(), fdata.begin() + numel, t->data.begin());
  } else if (!idata.empty()) {
    if (int64_t(idata.size()) < numel) return false;
    for (int64_t i = 0; i < numel; ++i) t->data[size_t(i)] = float(idata[i]);
  } else if (numel != 0) {
    return false;
  }
  return true;
}

bool parse_attr(const uint8_t* buf, uint64_t len, std::string* name,
                Attr* a) {
  Reader r{buf, buf + len};
  uint32_t field, wire;
  const uint8_t* pl;
  uint64_t n;
  while (r.next(&field, &wire, &pl, &n)) {
    switch (field) {
      case 1:
        if (wire == 2) *name = str_of(pl, n);
        break;
      case 2:
        if (wire == 5) {
          float f;
          memcpy(&f, pl, 4);
          a->f = f;
        }
        break;
      case 3:
        if (wire == 0) a->i = int64_t(n);
        break;
      case 4:
        if (wire == 2) a->s = str_of(pl, n);
        break;
      case 7:
        if (wire == 5) {
          float f;
          memcpy(&f, pl, 4);
          a->floats.push_back(f);
        } else if (wire == 2) {
          for (uint64_t i = 0; i + 4 <= n; i += 4) {
            float f;
            memcpy(&f, pl + i, 4);
            a->floats.push_back(f);
          }
        }
        break;
      case 8:
        if (wire == 0)
          a->ints.push_back(int64_t(n));
        else if (wire == 2) {
          Reader rr{pl, pl + n};
          while (rr.p < rr.end && rr.ok) a->ints.push_back(int64_t(rr.varint()));
        }
        break;
      default:
        break;
    }
  }
  return r.ok;
}

bool parse_node(const uint8_t* buf, uint64_t len, Node* node) {
  Reader r{buf, buf + len};
  uint32_t field, wire;
  const uint8_t* pl;
  uint64_t n;
  while (r.next(&field, &wire, &pl, &n)) {
    if (wire != 2) continue;  // all NodeProto fields we read are bytes
    switch (field) {
      case 1:
        node->inputs.push_back(str_of(pl, n));
        break;
      case 2:
        node->outputs.push_back(str_of(pl, n));
        break;
      case 4:
        node->op = str_of(pl, n);
        break;
      case 5: {
        std::string name;
        Attr a;
        if (!parse_attr(pl, n, &name, &a)) return false;
        node->attrs[name] = std::move(a);
        break;
      }
      default:
        break;
    }
  }
  return r.ok;
}

std::string value_info_name(const uint8_t* buf, uint64_t len) {
  Reader r{buf, buf + len};
  uint32_t field, wire;
  const uint8_t* pl;
  uint64_t n;
  while (r.next(&field, &wire, &pl, &n))
    if (field == 1 && wire == 2) return str_of(pl, n);
  return "";
}

bool parse_graph(const uint8_t* buf, uint64_t len, Graph* g) {
  Reader r{buf, buf + len};
  uint32_t field, wire;
  const uint8_t* pl;
  uint64_t n;
  std::vector<std::string> raw_inputs;
  while (r.next(&field, &wire, &pl, &n)) {
    if (wire != 2) continue;  // all GraphProto fields we read are bytes
    switch (field) {
      case 1: {
        Node node;
        if (!parse_node(pl, n, &node)) return false;
        g->nodes.push_back(std::move(node));
        break;
      }
      case 5: {
        std::string name;
        Tensor t;
        if (!parse_tensor(pl, n, &name, &t)) return false;
        g->initializers[name] = std::move(t);
        break;
      }
      case 11:
        raw_inputs.push_back(value_info_name(pl, n));
        break;
      case 12:
        g->outputs.push_back(value_info_name(pl, n));
        break;
      default:
        break;
    }
  }
  for (auto& name : raw_inputs)
    if (!g->initializers.count(name)) g->inputs.push_back(name);
  return r.ok;
}

bool parse_model(const uint8_t* buf, uint64_t len, Graph* g) {
  Reader r{buf, buf + len};
  uint32_t field, wire;
  const uint8_t* pl;
  uint64_t n;
  while (r.next(&field, &wire, &pl, &n))
    if (field == 7 && wire == 2) return parse_graph(pl, n, g);
  g_last_error = "no GraphProto in model";
  return false;
}

// ---------------------------------------------------------------------
// op kernels (NCHW, float32)
// ---------------------------------------------------------------------

std::vector<int64_t> attr_ints(const Node& nd, const char* key,
                               std::vector<int64_t> dflt) {
  auto it = nd.attrs.find(key);
  return it == nd.attrs.end() || it->second.ints.empty() ? dflt
                                                         : it->second.ints;
}

int64_t attr_i(const Node& nd, const char* key, int64_t dflt) {
  auto it = nd.attrs.find(key);
  return it == nd.attrs.end() ? dflt : it->second.i;
}

float attr_f(const Node& nd, const char* key, float dflt) {
  auto it = nd.attrs.find(key);
  return it == nd.attrs.end() ? dflt : it->second.f;
}

bool conv2d(const Node& nd, const Tensor& x, const Tensor& w,
            const Tensor* bias, Tensor* y) {
  if (x.shape.size() != 4 || w.shape.size() != 4) {
    g_last_error = "Conv: only 2-D convolution supported";
    return false;
  }
  int64_t N = x.shape[0], C = x.shape[1], H = x.shape[2], W = x.shape[3];
  int64_t O = w.shape[0], CI = w.shape[1], KH = w.shape[2], KW = w.shape[3];
  int64_t groups = attr_i(nd, "group", 1);
  auto strides = attr_ints(nd, "strides", {1, 1});
  auto dil = attr_ints(nd, "dilations", {1, 1});
  auto pads = attr_ints(nd, "pads", {0, 0, 0, 0});
  if (pads.size() >= 4 && (pads[0] != pads[2] || pads[1] != pads[3])) {
    g_last_error = "Conv: asymmetric pads unsupported";
    return false;
  }
  int64_t ph = pads[0], pw = pads[1];
  int64_t OH = (H + 2 * ph - dil[0] * (KH - 1) - 1) / strides[0] + 1;
  int64_t OW = (W + 2 * pw - dil[1] * (KW - 1) - 1) / strides[1] + 1;
  if (C != CI * groups) {
    g_last_error = "Conv: channel mismatch";
    return false;
  }
  y->shape = {N, O, OH, OW};
  y->data.assign(size_t(N * O * OH * OW), 0.f);
  int64_t opg = O / groups;
  for (int64_t nidx = 0; nidx < N; ++nidx)
    for (int64_t o = 0; o < O; ++o) {
      int64_t gidx = o / opg;
      for (int64_t oh = 0; oh < OH; ++oh)
        for (int64_t ow = 0; ow < OW; ++ow) {
          float acc = bias ? bias->data[size_t(o)] : 0.f;
          for (int64_t ci = 0; ci < CI; ++ci) {
            int64_t c = gidx * CI + ci;
            for (int64_t kh = 0; kh < KH; ++kh) {
              int64_t ih = oh * strides[0] + kh * dil[0] - ph;
              if (ih < 0 || ih >= H) continue;
              const float* xrow =
                  &x.data[size_t(((nidx * C + c) * H + ih) * W)];
              const float* wrow =
                  &w.data[size_t(((o * CI + ci) * KH + kh) * KW)];
              for (int64_t kw = 0; kw < KW; ++kw) {
                int64_t iw = ow * strides[1] + kw * dil[1] - pw;
                if (iw < 0 || iw >= W) continue;
                acc += xrow[iw] * wrow[kw];
              }
            }
          }
          y->data[size_t(((nidx * O + o) * OH + oh) * OW + ow)] = acc;
        }
    }
  return true;
}

bool pool2d(const Node& nd, const Tensor& x, Tensor* y, bool is_max,
            bool global_pool) {
  int64_t N = x.shape[0], C = x.shape[1], H = x.shape[2], W = x.shape[3];
  std::vector<int64_t> kernel, strides, pads;
  bool ceil_mode = false;
  bool count_include_pad = true;
  if (global_pool) {
    kernel = {H, W};
    strides = {1, 1};
    pads = {0, 0, 0, 0};
  } else {
    kernel = attr_ints(nd, "kernel_shape", {1, 1});
    strides = attr_ints(nd, "strides", {1, 1});
    pads = attr_ints(nd, "pads", {0, 0, 0, 0});
    ceil_mode = attr_i(nd, "ceil_mode", 0) != 0;
    count_include_pad = attr_i(nd, "count_include_pad", 1) != 0;
  }
  if (pads.size() >= 4 && (pads[0] != pads[2] || pads[1] != pads[3])) {
    g_last_error = "Pool: asymmetric pads unsupported";
    return false;
  }
  int64_t ph = pads[0], pw = pads[1];
  auto osz = [&](int64_t in, int64_t k, int64_t s, int64_t p) {
    int64_t span = in + 2 * p - k;
    return (ceil_mode ? (span + s - 1) / s : span / s) + 1;
  };
  int64_t OH = osz(H, kernel[0], strides[0], ph);
  int64_t OW = osz(W, kernel[1], strides[1], pw);
  y->shape = {N, C, OH, OW};
  y->data.assign(size_t(N * C * OH * OW), 0.f);
  for (int64_t nidx = 0; nidx < N; ++nidx)
    for (int64_t c = 0; c < C; ++c)
      for (int64_t oh = 0; oh < OH; ++oh)
        for (int64_t ow = 0; ow < OW; ++ow) {
          float best = -3.4e38f;
          float sum = 0.f;
          int64_t cnt = 0;
          for (int64_t kh = 0; kh < kernel[0]; ++kh) {
            int64_t ih = oh * strides[0] + kh - ph;
            if (ih < 0 || ih >= H) continue;
            for (int64_t kw = 0; kw < kernel[1]; ++kw) {
              int64_t iw = ow * strides[1] + kw - pw;
              if (iw < 0 || iw >= W) continue;
              float v = x.data[size_t(((nidx * C + c) * H + ih) * W + iw)];
              best = v > best ? v : best;
              sum += v;
              cnt++;
            }
          }
          float out;
          if (is_max)
            out = cnt ? best : 0.f;
          else if (count_include_pad)
            out = sum / float(kernel[0] * kernel[1]);
          else
            out = cnt ? sum / float(cnt) : 0.f;
          y->data[size_t(((nidx * C + c) * OH + oh) * OW + ow)] = out;
        }
  return true;
}

void gemm(const Tensor& a, const Tensor& b, const Tensor* bias, bool transB,
          Tensor* y) {
  int64_t M = a.shape[0], K = a.shape[1];
  int64_t N = transB ? b.shape[0] : b.shape[1];
  y->shape = {M, N};
  y->data.assign(size_t(M * N), 0.f);
  for (int64_t m = 0; m < M; ++m)
    for (int64_t n = 0; n < N; ++n) {
      float acc = bias ? bias->data[size_t(n % int64_t(bias->data.size()))]
                       : 0.f;
      const float* arow = &a.data[size_t(m * K)];
      if (transB) {
        const float* brow = &b.data[size_t(n * K)];
        for (int64_t k = 0; k < K; ++k) acc += arow[k] * brow[k];
      } else {
        for (int64_t k = 0; k < K; ++k)
          acc += arow[k] * b.data[size_t(k * N + n)];
      }
      y->data[size_t(m * N + n)] = acc;
    }
}

// numpy-style broadcast binary op
bool broadcast_binop(const Tensor& a, const Tensor& b, int kind, Tensor* y) {
  size_t nd = std::max(a.shape.size(), b.shape.size());
  std::vector<int64_t> sa(nd, 1), sb(nd, 1), so(nd, 1);
  std::copy(a.shape.begin(), a.shape.end(),
            sa.begin() + (nd - a.shape.size()));
  std::copy(b.shape.begin(), b.shape.end(),
            sb.begin() + (nd - b.shape.size()));
  for (size_t i = 0; i < nd; ++i) {
    if (sa[i] != sb[i] && sa[i] != 1 && sb[i] != 1) {
      g_last_error = "broadcast shape mismatch";
      return false;
    }
    so[i] = std::max(sa[i], sb[i]);
  }
  y->shape = so;
  int64_t total = 1;
  for (auto d : so) total *= d;
  y->data.resize(size_t(total));
  std::vector<int64_t> stra(nd), strb(nd);
  int64_t ra = 1, rb = 1;
  for (size_t i = nd; i-- > 0;) {
    stra[i] = (sa[i] == 1) ? 0 : ra;
    strb[i] = (sb[i] == 1) ? 0 : rb;
    ra *= sa[i];
    rb *= sb[i];
  }
  std::vector<int64_t> idx(nd, 0);
  for (int64_t flat = 0; flat < total; ++flat) {
    int64_t ia = 0, ib = 0;
    for (size_t i = 0; i < nd; ++i) {
      ia += idx[i] * stra[i];
      ib += idx[i] * strb[i];
    }
    float va = a.data[size_t(ia)], vb = b.data[size_t(ib)];
    float out = 0;
    switch (kind) {
      case 0: out = va + vb; break;
      case 1: out = va - vb; break;
      case 2: out = va * vb; break;
      case 3: out = va / vb; break;
    }
    y->data[size_t(flat)] = out;
    for (size_t i = nd; i-- > 0;) {
      if (++idx[i] < so[i]) break;
      idx[i] = 0;
    }
  }
  return true;
}

// ---------------------------------------------------------------------
// the predictor
// ---------------------------------------------------------------------

struct Predictor {
  Graph graph;
  std::map<std::string, Tensor> env;
  std::vector<Tensor> outputs;
  bool ran = false;

  const Tensor* get(const std::string& name) {
    auto it = env.find(name);
    if (it != env.end()) return &it->second;
    auto it2 = graph.initializers.find(name);
    if (it2 != graph.initializers.end()) return &it2->second;
    return nullptr;
  }

  bool run() {
    for (auto& nd : graph.nodes) {
      std::vector<const Tensor*> in;
      for (auto& nm : nd.inputs) {
        const Tensor* t = get(nm);
        if (!t && !nm.empty()) {
          g_last_error = "missing tensor " + nm + " for op " + nd.op;
          return false;
        }
        in.push_back(t);
      }
      Tensor out;
      const std::string& op = nd.op;
      bool ok = true;
      if (op == "Conv") {
        ok = conv2d(nd, *in[0], *in[1], in.size() > 2 ? in[2] : nullptr,
                    &out);
      } else if (op == "MaxPool") {
        ok = pool2d(nd, *in[0], &out, true, false);
      } else if (op == "AveragePool") {
        ok = pool2d(nd, *in[0], &out, false, false);
      } else if (op == "GlobalAveragePool") {
        ok = pool2d(nd, *in[0], &out, false, true);
      } else if (op == "GlobalMaxPool") {
        ok = pool2d(nd, *in[0], &out, true, true);
      } else if (op == "Gemm") {
        if (attr_f(nd, "alpha", 1.f) != 1.f ||
            attr_f(nd, "beta", 1.f) != 1.f ||
            attr_i(nd, "transA", 0) != 0) {
          g_last_error = "Gemm: alpha/beta != 1 or transA unsupported";
          ok = false;
        } else {
          gemm(*in[0], *in[1], in.size() > 2 ? in[2] : nullptr,
               attr_i(nd, "transB", 0) != 0, &out);
        }
      } else if (op == "MatMul") {
        if (in[0]->shape.size() != 2 || in[1]->shape.size() != 2) {
          g_last_error = "MatMul: only rank-2 supported";
          ok = false;
        } else {
          gemm(*in[0], *in[1], nullptr, false, &out);
        }
      } else if (op == "BatchNormalization") {
        const Tensor &x = *in[0], &sc = *in[1], &b = *in[2], &mu = *in[3],
                     &var = *in[4];
        float eps = attr_f(nd, "epsilon", 1e-5f);
        out.shape = x.shape;
        out.data.resize(x.data.size());
        int64_t C = x.shape.size() > 1 ? x.shape[1] : x.shape[0];
        int64_t inner = 1;
        for (size_t i = 2; i < x.shape.size(); ++i) inner *= x.shape[i];
        int64_t N = x.shape.empty() ? 1 : x.shape[0];
        for (int64_t nidx = 0; nidx < N; ++nidx)
          for (int64_t c = 0; c < C; ++c) {
            float s = sc.data[size_t(c)] /
                      std::sqrt(var.data[size_t(c)] + eps);
            float off = b.data[size_t(c)] - mu.data[size_t(c)] * s;
            float* dst = &out.data[size_t((nidx * C + c) * inner)];
            const float* src = &x.data[size_t((nidx * C + c) * inner)];
            for (int64_t i = 0; i < inner; ++i) dst[i] = src[i] * s + off;
          }
      } else if (op == "Relu") {
        out.shape = in[0]->shape;
        out.data.resize(in[0]->data.size());
        for (size_t i = 0; i < out.data.size(); ++i)
          out.data[i] = in[0]->data[i] > 0 ? in[0]->data[i] : 0;
      } else if (op == "Sigmoid" || op == "Tanh" || op == "Softplus" ||
                 op == "Sqrt" || op == "Exp" || op == "Log" ||
                 op == "Abs" || op == "Neg" || op == "Identity" ||
                 op == "Floor" || op == "Ceil" || op == "Erf") {
        out.shape = in[0]->shape;
        out.data.resize(in[0]->data.size());
        for (size_t i = 0; i < out.data.size(); ++i) {
          float v = in[0]->data[i];
          if (op == "Sigmoid") v = 1.f / (1.f + std::exp(-v));
          else if (op == "Tanh") v = std::tanh(v);
          else if (op == "Softplus") v = std::log1p(std::exp(v));
          else if (op == "Sqrt") v = std::sqrt(v);
          else if (op == "Exp") v = std::exp(v);
          else if (op == "Log") v = std::log(v);
          else if (op == "Abs") v = std::fabs(v);
          else if (op == "Neg") v = -v;
          else if (op == "Floor") v = std::floor(v);
          else if (op == "Ceil") v = std::ceil(v);
          else if (op == "Erf") v = std::erf(v);
          out.data[i] = v;
        }
      } else if (op == "LeakyRelu" || op == "Elu") {
        float alpha = attr_f(nd, "alpha", op == "Elu" ? 1.0f : 0.01f);
        out.shape = in[0]->shape;
        out.data.resize(in[0]->data.size());
        for (size_t i = 0; i < out.data.size(); ++i) {
          float v = in[0]->data[i];
          out.data[i] = v > 0 ? v
                              : (op == "Elu" ? alpha * std::expm1(v)
                                             : alpha * v);
        }
      } else if (op == "Add" || op == "Sub" || op == "Mul" || op == "Div") {
        int kind = op == "Add" ? 0 : op == "Sub" ? 1 : op == "Mul" ? 2 : 3;
        ok = broadcast_binop(*in[0], *in[1], kind, &out);
      } else if (op == "Softmax") {
        int64_t axis = attr_i(nd, "axis", -1);
        const Tensor& x = *in[0];
        size_t nd_ = x.shape.size();
        if (axis < 0) axis += int64_t(nd_);
        if (axis != int64_t(nd_) - 1) {
          g_last_error = "Softmax: only last axis supported";
          ok = false;
        } else {
          out.shape = x.shape;
          out.data.resize(x.data.size());
          int64_t inner = x.shape.back();
          int64_t outer = x.numel() / inner;
          for (int64_t o = 0; o < outer; ++o) {
            const float* src = &x.data[size_t(o * inner)];
            float* dst = &out.data[size_t(o * inner)];
            float mx = src[0];
            for (int64_t i = 1; i < inner; ++i) mx = std::max(mx, src[i]);
            float tot = 0;
            for (int64_t i = 0; i < inner; ++i) {
              dst[i] = std::exp(src[i] - mx);
              tot += dst[i];
            }
            for (int64_t i = 0; i < inner; ++i) dst[i] /= tot;
          }
        }
      } else if (op == "Flatten") {
        const Tensor& x = *in[0];
        int64_t axis = attr_i(nd, "axis", 1);
        int64_t outer = 1, inner = 1;
        for (size_t i = 0; i < x.shape.size(); ++i)
          (int64_t(i) < axis ? outer : inner) *= x.shape[i];
        out.shape = {outer, inner};
        out.data = x.data;
      } else if (op == "Reshape") {
        const Tensor& x = *in[0];
        const Tensor& shp = *in[1];
        std::vector<int64_t> ns;
        int64_t known = 1, infer = -1;
        for (size_t i = 0; i < shp.data.size(); ++i) {
          int64_t d = int64_t(shp.data[i]);
          if (d == 0) d = x.shape[i];
          if (d == -1) {
            infer = int64_t(ns.size());
            ns.push_back(1);
          } else {
            ns.push_back(d);
            known *= d;
          }
        }
        if (infer >= 0) ns[size_t(infer)] = x.numel() / known;
        out.shape = ns;
        out.data = x.data;
      } else if (op == "Transpose") {
        const Tensor& x = *in[0];
        auto perm = attr_ints(nd, "perm", {});
        size_t nd_ = x.shape.size();
        if (perm.empty())
          for (size_t i = nd_; i-- > 0;) perm.push_back(int64_t(i));
        out.shape.resize(nd_);
        for (size_t i = 0; i < nd_; ++i)
          out.shape[i] = x.shape[size_t(perm[i])];
        out.data.resize(x.data.size());
        std::vector<int64_t> strides(nd_, 1), ostrides(nd_, 1);
        for (size_t i = nd_ - 1; i-- > 0;)
          strides[i] = strides[i + 1] * x.shape[i + 1];
        for (size_t i = nd_ - 1; i-- > 0;)
          ostrides[i] = ostrides[i + 1] * out.shape[i + 1];
        std::vector<int64_t> idx(nd_, 0);
        for (int64_t flat = 0; flat < x.numel(); ++flat) {
          int64_t src = 0;
          for (size_t i = 0; i < nd_; ++i)
            src += idx[i] * strides[size_t(perm[i])];
          out.data[size_t(flat)] = x.data[size_t(src)];
          for (size_t i = nd_; i-- > 0;) {
            if (++idx[i] < out.shape[i]) break;
            idx[i] = 0;
          }
        }
      } else if (op == "Concat") {
        int64_t axis = attr_i(nd, "axis", 1);
        const Tensor& first = *in[0];
        size_t nd_ = first.shape.size();
        if (axis < 0) axis += int64_t(nd_);
        out.shape = first.shape;
        int64_t cat = 0;
        for (auto* t : in) cat += t->shape[size_t(axis)];
        out.shape[size_t(axis)] = cat;
        int64_t outer = 1, inner = 1;
        for (int64_t i = 0; i < axis; ++i) outer *= first.shape[size_t(i)];
        for (size_t i = size_t(axis) + 1; i < nd_; ++i)
          inner *= first.shape[i];
        out.data.resize(size_t(outer * cat * inner));
        int64_t off = 0;
        for (auto* t : in) {
          int64_t ax = t->shape[size_t(axis)];
          for (int64_t o = 0; o < outer; ++o)
            memcpy(&out.data[size_t((o * cat + off) * inner)],
                   &t->data[size_t(o * ax * inner)],
                   size_t(ax * inner) * 4);
          off += ax;
        }
      } else if (op == "Clip") {
        float lo = in.size() > 1 && in[1] ? in[1]->data[0]
                                          : attr_f(nd, "min", -3.4e38f);
        float hi = in.size() > 2 && in[2] ? in[2]->data[0]
                                          : attr_f(nd, "max", 3.4e38f);
        out.shape = in[0]->shape;
        out.data.resize(in[0]->data.size());
        for (size_t i = 0; i < out.data.size(); ++i)
          out.data[i] = std::min(hi, std::max(lo, in[0]->data[i]));
      } else if (op == "Gather") {
        // axis-0 gather (Embedding)
        const Tensor& table = *in[0];
        const Tensor& idxs = *in[1];
        int64_t row = table.numel() / table.shape[0];
        out.shape = idxs.shape;
        for (size_t i = 1; i < table.shape.size(); ++i)
          out.shape.push_back(table.shape[i]);
        out.data.resize(size_t(idxs.numel() * row));
        for (int64_t i = 0; i < idxs.numel(); ++i)
          memcpy(&out.data[size_t(i * row)],
                 &table.data[size_t(int64_t(idxs.data[size_t(i)]) * row)],
                 size_t(row) * 4);
      } else if (op == "Unsqueeze") {
        const Tensor& x = *in[0];
        int64_t ax = in.size() > 1 && in[1] ? int64_t(in[1]->data[0])
                                            : attr_ints(nd, "axes", {0})[0];
        out.shape = x.shape;
        if (ax < 0) ax += int64_t(x.shape.size()) + 1;
        out.shape.insert(out.shape.begin() + ax, 1);
        out.data = x.data;
      } else {
        g_last_error = "unsupported op " + op;
        ok = false;
      }
      if (!ok) return false;
      env[nd.outputs[0]] = std::move(out);
    }
    outputs.clear();
    for (auto& nm : graph.outputs) {
      const Tensor* t = get(nm);
      if (!t) {
        g_last_error = "missing graph output " + nm;
        return false;
      }
      outputs.push_back(*t);
    }
    ran = true;
    return true;
  }
};

// ---------------------------------------------------------------------
// .params container reader (reference: c_predict_api.h :: MXNDListCreate
// over src/ndarray/ndarray.cc :: NDArray::Load).  Same dependency-free
// contract as the ONNX runtime: parameter files load with no Python in
// the loop.  Layout (little-endian; see mxnet_tpu/ndarray/ndarray.py
// and tests/test_params_format.py, which lock it byte-for-byte):
//   u64 list magic 0x112 | u64 reserved | u64 count
//   per array: u32 magic 0xF993FAC9 | i32 stype(0=dense) | u32 ndim |
//              i64*ndim dims | i32 dev_type + i32 dev_id | i32 dtype
//              flag | raw element bytes
//   u64 name count | per name: u64 byte length + utf-8
// ---------------------------------------------------------------------

struct NDList {
  std::vector<std::string> names;
  std::vector<Tensor> arrays;
};

struct LEReader {
  const uint8_t* p;
  const uint8_t* end;
  bool ok = true;

  bool take(void* dst, size_t n) {
    if (!ok || size_t(end - p) < n) {
      ok = false;
      return false;
    }
    memcpy(dst, p, n);
    p += n;
    return true;
  }
  uint64_t u64() { uint64_t v = 0; take(&v, 8); return v; }
  uint32_t u32() { uint32_t v = 0; take(&v, 4); return v; }
  int32_t i32() { int32_t v = 0; take(&v, 4); return v; }
  int64_t i64() { int64_t v = 0; take(&v, 8); return v; }
};

float half_to_float(uint16_t h) {
  uint32_t sign = uint32_t(h & 0x8000u) << 16;
  uint32_t exp = (h >> 10) & 0x1F;
  uint32_t man = h & 0x3FF;
  uint32_t bits;
  if (exp == 0) {
    if (man == 0) {
      bits = sign;                       // +-0
    } else {                             // subnormal: renormalize
      uint32_t e = 127 - 15 + 1;
      while (!(man & 0x400)) { man <<= 1; --e; }
      bits = sign | (e << 23) | ((man & 0x3FF) << 13);
    }
  } else if (exp == 31) {
    bits = sign | 0x7F800000u | (man << 13);   // inf/nan
  } else {
    bits = sign | ((exp - 15 + 127) << 23) | (man << 13);
  }
  float f;
  memcpy(&f, &bits, 4);
  return f;
}

template <typename T>
bool read_as_float(LEReader* r, int64_t n, std::vector<float>* out) {
  std::vector<T> tmp(static_cast<size_t>(n));
  if (!r->take(tmp.data(), size_t(n) * sizeof(T))) return false;
  for (int64_t i = 0; i < n; ++i) (*out)[size_t(i)] = float(tmp[size_t(i)]);
  return true;
}

bool parse_params(const uint8_t* data, uint64_t len, NDList* out) {
  LEReader r{data, data + len};
  if (r.u64() != 0x112) {
    g_last_error = "bad .params list magic";
    return false;
  }
  r.u64();  // reserved
  uint64_t count = r.u64();
  // each serialized array needs >= 24 bytes of header alone: bounding
  // count by the remaining bytes stops a tiny crafted file from
  // forcing a huge up-front allocation
  if (!r.ok || count > uint64_t(r.end - r.p) / 24) {
    g_last_error = "corrupt .params header";
    return false;
  }
  out->arrays.resize(size_t(count));
  for (auto& t : out->arrays) {
    if (r.u32() != 0xF993FAC9u) {
      g_last_error = "bad ndarray magic in .params";
      return false;
    }
    if (r.i32() != 0) {
      g_last_error = ".params: only dense arrays supported";
      return false;
    }
    uint32_t ndim = r.u32();
    if (!r.ok || ndim > 32) {
      g_last_error = ".params: corrupt ndarray rank";
      return false;
    }
    t.shape.resize(ndim);
    // overflow-checked element count: crafted dims like [2^32, 2^32]
    // would wrap numel() to a small value and desynchronize the size
    // check from the shape handed to the C caller
    int64_t n = 1;
    for (auto& d : t.shape) {
      d = r.i64();
      if (!r.ok || d < 0 ||
          (d != 0 && n > INT64_MAX / (d ? d : 1))) {
        g_last_error = ".params: corrupt ndarray dims";
        return false;
      }
      n *= d;
    }
    r.i32();
    r.i32();  // dev_type, dev_id
    int32_t flag = r.i32();
    if (!r.ok || uint64_t(n) > uint64_t(r.end - r.p)) {
      g_last_error = ".params: corrupt ndarray size";
      return false;
    }
    t.data.resize(size_t(n));
    bool good = true;
    switch (flag) {
      case 0:   // float32
        good = r.take(t.data.data(), size_t(n) * 4);
        break;
      case 1: good = read_as_float<double>(&r, n, &t.data); break;
      case 2: {  // float16
        std::vector<uint16_t> tmp(static_cast<size_t>(n));
        good = r.take(tmp.data(), size_t(n) * 2);
        if (good)
          for (int64_t i = 0; i < n; ++i)
            t.data[size_t(i)] = half_to_float(tmp[size_t(i)]);
        break;
      }
      case 3: good = read_as_float<uint8_t>(&r, n, &t.data); break;
      case 4: good = read_as_float<int32_t>(&r, n, &t.data); break;
      case 5: good = read_as_float<int8_t>(&r, n, &t.data); break;
      case 6: good = read_as_float<int64_t>(&r, n, &t.data); break;
      case 100: {  // bfloat16: high 16 bits of a float32
        std::vector<uint16_t> tmp(static_cast<size_t>(n));
        good = r.take(tmp.data(), size_t(n) * 2);
        if (good)
          for (int64_t i = 0; i < n; ++i) {
            uint32_t bits = uint32_t(tmp[size_t(i)]) << 16;
            memcpy(&t.data[size_t(i)], &bits, 4);
          }
        break;
      }
      default:
        g_last_error = ".params: unsupported dtype flag";
        return false;
    }
    if (!good) {
      g_last_error = ".params: truncated tensor data";
      return false;
    }
  }
  uint64_t nnames = r.u64();
  if (!r.ok || (nnames != 0 && nnames != count)) {
    g_last_error = ".params: corrupt name table";
    return false;
  }
  out->names.resize(size_t(nnames));
  for (auto& s : out->names) {
    uint64_t ln = r.u64();
    if (!r.ok || ln > uint64_t(r.end - r.p)) {
      g_last_error = ".params: corrupt name entry";
      return false;
    }
    s.assign(reinterpret_cast<const char*>(r.p), size_t(ln));
    r.p += ln;
  }
  return r.ok;
}

}  // namespace

// ---------------------------------------------------------------------
// C ABI (reference: c_predict_api.h)
// ---------------------------------------------------------------------

extern "C" {

typedef void* PredictorHandle;

const char* MXPredGetLastError() { return g_last_error.c_str(); }

int MXPredCreate(const char* model_bytes, int64_t model_len,
                 PredictorHandle* out) {
  auto pred = std::make_unique<Predictor>();
  if (!parse_model(reinterpret_cast<const uint8_t*>(model_bytes),
                   uint64_t(model_len), &pred->graph)) {
    if (g_last_error.empty()) g_last_error = "malformed ONNX model";
    return -1;
  }
  *out = pred.release();
  return 0;
}

int MXPredCreateFromFile(const char* path, PredictorHandle* out) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    g_last_error = std::string("cannot open ") + path;
    return -1;
  }
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  if (len < 0) {
    fclose(f);
    g_last_error = "cannot determine file size";
    return -1;
  }
  fseek(f, 0, SEEK_SET);
  try {
    std::vector<char> buf(static_cast<size_t>(len), 0);
    size_t got = fread(buf.data(), 1, size_t(len), f);
    fclose(f);
    if (got != size_t(len)) {
      g_last_error = "short read";
      return -1;
    }
    return MXPredCreate(buf.data(), len, out);
  } catch (const std::exception& e) {
    fclose(f);
    g_last_error = e.what();
    return -1;
  }
}

int MXPredSetInput(PredictorHandle h, const char* name, const float* data,
                   const int64_t* shape, int ndim) {
  auto* pred = static_cast<Predictor*>(h);
  Tensor t;
  t.shape.assign(shape, shape + ndim);
  t.data.assign(data, data + t.numel());
  std::string nm = name && name[0] ? name
                                   : (pred->graph.inputs.empty()
                                          ? std::string("data")
                                          : pred->graph.inputs[0]);
  pred->env[nm] = std::move(t);
  return 0;
}

int MXPredForward(PredictorHandle h) {
  auto* pred = static_cast<Predictor*>(h);
  return pred->run() ? 0 : -1;
}

int MXPredGetOutputShape(PredictorHandle h, int index, int64_t* shape,
                         int* ndim) {
  auto* pred = static_cast<Predictor*>(h);
  if (!pred->ran || index < 0 ||
      size_t(index) >= pred->outputs.size()) {
    g_last_error = "no such output (forward not run?)";
    return -1;
  }
  const Tensor& t = pred->outputs[size_t(index)];
  *ndim = int(t.shape.size());
  if (shape)
    for (size_t i = 0; i < t.shape.size(); ++i) shape[i] = t.shape[i];
  return 0;
}

int MXPredGetOutput(PredictorHandle h, int index, float* out,
                    int64_t size) {
  auto* pred = static_cast<Predictor*>(h);
  if (!pred->ran || index < 0 ||
      size_t(index) >= pred->outputs.size()) {
    g_last_error = "no such output (forward not run?)";
    return -1;
  }
  const Tensor& t = pred->outputs[size_t(index)];
  if (size < t.numel()) {
    g_last_error = "output buffer too small";
    return -1;
  }
  memcpy(out, t.data.data(), size_t(t.numel()) * 4);
  return 0;
}

void MXPredFree(PredictorHandle h) { delete static_cast<Predictor*>(h); }

// -- .params list ABI (reference: c_predict_api.h :: MXNDListCreate /
// MXNDListGet / MXNDListFree; values are exposed as float like the
// reference, whatever the stored dtype) ------------------------------

typedef void* NDListHandle;

int MXNDListCreate(const char* nd_file_bytes, int64_t nd_file_size,
                   NDListHandle* out, int64_t* out_length) {
  try {
    auto list = std::make_unique<NDList>();
    if (!parse_params(reinterpret_cast<const uint8_t*>(nd_file_bytes),
                      uint64_t(nd_file_size), list.get())) {
      if (g_last_error.empty()) g_last_error = "malformed .params file";
      return -1;
    }
    if (out_length) *out_length = int64_t(list->arrays.size());
    *out = list.release();
    return 0;
  } catch (const std::exception& e) {
    g_last_error = e.what();
    return -1;
  }
}

int MXNDListCreateFromFile(const char* path, NDListHandle* out,
                           int64_t* out_length) {
  FILE* f = fopen(path, "rb");
  if (!f) {
    g_last_error = std::string("cannot open ") + path;
    return -1;
  }
  fseek(f, 0, SEEK_END);
  long len = ftell(f);
  if (len < 0) {
    fclose(f);
    g_last_error = "cannot determine file size";
    return -1;
  }
  fseek(f, 0, SEEK_SET);
  try {
    std::vector<char> buf(static_cast<size_t>(len), 0);
    size_t got = fread(buf.data(), 1, size_t(len), f);
    fclose(f);
    if (got != size_t(len)) {
      g_last_error = "short read";
      return -1;
    }
    return MXNDListCreate(buf.data(), len, out, out_length);
  } catch (const std::exception& e) {
    fclose(f);
    g_last_error = e.what();
    return -1;
  }
}

int MXNDListGet(NDListHandle h, int64_t index, const char** out_key,
                const float** out_data, const int64_t** out_shape,
                int* out_ndim) {
  auto* list = static_cast<NDList*>(h);
  if (index < 0 || size_t(index) >= list->arrays.size()) {
    g_last_error = "MXNDListGet: index out of range";
    return -1;
  }
  const Tensor& t = list->arrays[size_t(index)];
  if (out_key)
    *out_key = size_t(index) < list->names.size()
                   ? list->names[size_t(index)].c_str()
                   : "";
  if (out_data) *out_data = t.data.data();
  if (out_shape) *out_shape = t.shape.data();
  if (out_ndim) *out_ndim = int(t.shape.size());
  return 0;
}

void MXNDListFree(NDListHandle h) { delete static_cast<NDList*>(h); }

}  // extern "C"
