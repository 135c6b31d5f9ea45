/* C predict API (reference: include/mxnet/c_predict_api.h).
 *
 * Self-contained edge inference over exported ONNX artifacts
 * (mx.onnx.export_model): no Python, no protobuf, no BLAS.  Build the
 * runtime with:
 *
 *   g++ -O2 -shared -fPIC -std=c++17 predict_native.cc -o libmxtpu_predict.so
 *
 * and link this header's functions against it.  All tensors are float32;
 * shapes are int64.  Functions return 0 on success, -1 on failure with
 * the message available from MXPredGetLastError().
 */
#ifndef MXNET_TPU_PREDICT_H_
#define MXNET_TPU_PREDICT_H_

#include <stdint.h>

#ifdef __cplusplus
extern "C" {
#endif

typedef void* PredictorHandle;

const char* MXPredGetLastError(void);

/* Create a predictor from in-memory ONNX bytes / an .onnx file. */
int MXPredCreate(const char* model_bytes, int64_t model_len,
                 PredictorHandle* out);
int MXPredCreateFromFile(const char* path, PredictorHandle* out);

/* Bind an input by name (NULL or "" = the graph's first input). */
int MXPredSetInput(PredictorHandle h, const char* name, const float* data,
                   const int64_t* shape, int ndim);

int MXPredForward(PredictorHandle h);

/* Query output `index`: shape first (shape may be NULL to get ndim),
 * then the data. */
int MXPredGetOutputShape(PredictorHandle h, int index, int64_t* shape,
                         int* ndim);
int MXPredGetOutput(PredictorHandle h, int index, float* out, int64_t size);

void MXPredFree(PredictorHandle h);

/* .params parameter-container reader (reference: c_predict_api.h ::
 * MXNDListCreate/MXNDListGet/MXNDListFree).  Loads the framework's
 * .params files with no Python in the loop; stored dtypes (fp32/fp64/
 * fp16/bf16/int8..int64/uint8) are exposed as float, as upstream does.
 * Pointers returned by MXNDListGet stay valid until MXNDListFree. */
typedef void* NDListHandle;
int MXNDListCreate(const char* nd_file_bytes, int64_t nd_file_size,
                   NDListHandle* out, int64_t* out_length);
int MXNDListCreateFromFile(const char* path, NDListHandle* out,
                           int64_t* out_length);
int MXNDListGet(NDListHandle h, int64_t index, const char** out_key,
                const float** out_data, const int64_t** out_shape,
                int* out_ndim);
void MXNDListFree(NDListHandle h);

#ifdef __cplusplus
}
#endif

#endif /* MXNET_TPU_PREDICT_H_ */
