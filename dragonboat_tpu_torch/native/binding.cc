// Implementation of the embedding C ABI (dragonboat_tpu.h) over libpython.
//
// Counterpart of the reference's binding/binding.go (cgo exports over the
// Go runtime). A thin Python glue module (_GLUE below) is loaded into the
// embedded interpreter once; every C call then acquires the GIL, invokes
// one glue function, and converts results. The GIL is released between
// calls so the framework's own Python threads (step workers, transport,
// tick loop) run freely.
//
// Error discipline: glue functions raise framework exceptions; the C layer
// classifies them into DBTPU_ERR_* codes by exception type name (cf. the
// reference's getErrorCode in binding.go) and copies the message into the
// caller's err buffer. Request outcomes (RequestResult codes) are mapped
// to the same code space by the glue's _abi_code.

#include "dragonboat_tpu.h"

// required for '#' length formats to take Py_ssize_t (fatal abort
// otherwise on Python >= 3.10)
#define PY_SSIZE_T_CLEAN
#include <Python.h>

#include <cstdio>
#include <cstring>
#include <mutex>
#include <string>

namespace {

const char* _GLUE = R"PY(
import json as _json
import os as _os
import threading as _threading

# The PyTorch package's glue (dragonboat_tpu_torch): everything outside
# this string is the text of native/binding/binding.cc, over its header.
from dragonboat_tpu_torch.config import Config, EngineConfig, NodeHostConfig
from dragonboat_tpu_torch.nodehost import NodeHost
from dragonboat_tpu_torch.cpp_sm import CppStateMachineFactory

# the engine's device: the card unless the embedder asked for the CPU
# (DBTPU_DEVICE=cpu); without a card the default raises at NodeHost start
_DEVICE = _os.environ.get("DBTPU_DEVICE") or "cuda"

_hosts = {}
_factories = {}
_sessions = {}
_requests = {}
_lock = _threading.Lock()
_next_handle = 1


def _handle():
    global _next_handle
    with _lock:
        h = _next_handle
        _next_handle += 1
        return h


# RequestResult codes (requests.py REQUEST_*) -> ABI DBTPU_* codes
_CODE_MAP = {1: 0, 0: -2, 2: -7, 3: -4, 4: -6}


def _abi_code(code):
    return _CODE_MAP.get(code, -1)


def new_nodehost(cfg_json):
    nh = NodeHost(NodeHostConfig(engine=EngineConfig(device=_DEVICE),
                                 **_json.loads(cfg_json)))
    h = _handle()
    _hosts[h] = nh
    return h


def stop_nodehost(h):
    _hosts.pop(h).stop()


def start_cluster(h, members_json, join, plugin_path, cc_json):
    members = {int(k): v for k, v in _json.loads(members_json).items()}
    factory = _factories.get(plugin_path)
    if factory is None:
        factory = CppStateMachineFactory(plugin_path)
        _factories[plugin_path] = factory
    _hosts[h].start_cluster(
        members, bool(join), factory, Config(**_json.loads(cc_json))
    )


def stop_cluster(h, cluster_id):
    _hosts[h].stop_cluster(cluster_id)


# ------------------------------------------------------------- sessions


def session_noop(h, cluster_id):
    s = _hosts[h].get_noop_session(cluster_id)
    sh = _handle()
    _sessions[sh] = s
    return sh


def session_open(h, cluster_id, timeout_s):
    s = _hosts[h].sync_get_session(cluster_id, timeout_s)
    sh = _handle()
    _sessions[sh] = s
    return sh


def session_close(h, sh, timeout_s):
    # unregister FIRST: a failed/timed-out close keeps the handle so the
    # caller can retry instead of leaking the session cluster-side
    _hosts[h].sync_close_session(_sessions[sh], timeout_s)
    _sessions.pop(sh, None)


def session_proposal_completed(h, sh):
    _sessions[sh].proposal_completed()


def session_release(h, sh):
    _sessions.pop(sh, None)


# ------------------------------------------------------------ proposals


def sync_propose(h, cluster_id, cmd, timeout_s):
    nh = _hosts[h]
    session = nh.get_noop_session(cluster_id)
    return nh.sync_propose(session, cmd, timeout_s).value


def sync_propose_session(h, sh, cmd, timeout_s):
    return _hosts[h].sync_propose(_sessions[sh], cmd, timeout_s).value


def propose(h, sh, cmd, timeout_s):
    rs = _hosts[h].propose(_sessions[sh], cmd, timeout_s)
    rh = _handle()
    _requests[rh] = rs
    return rh


def read_index(h, cluster_id, timeout_s):
    rs = _hosts[h].read_index(cluster_id, timeout_s)
    rh = _handle()
    _requests[rh] = rs
    return rh


def request_wait(h, rh, wait_s):
    rs = _requests[rh]
    rs.wait(wait_s if wait_s > 0 else None)
    if not rs.done():
        return None  # wait elapsed, request still in flight; handle live
    # read the REAL result: wait() returns a synthetic timeout record on
    # expiry, and completion can land between the expiry and the done()
    # check above
    r = rs.result
    _requests.pop(rh, None)
    return (_abi_code(r.code), r.result.value if r.result else 0)


def request_poll(h, rh):
    r = _requests[rh].result
    if r is None:
        return None
    _requests.pop(rh, None)
    return (_abi_code(r.code), r.result.value if r.result else 0)


def request_on_complete(h, rh, cb):
    rs = _requests[rh]

    def fire(done_rs):
        r = done_rs.result
        _requests.pop(rh, None)
        cb(_abi_code(r.code), r.result.value if r.result else 0)

    # fires from the completing engine thread: O(1) threads regardless of
    # how many async requests are outstanding
    rs.on_complete(fire)


def request_release(h, rh):
    _requests.pop(rh, None)


# ---------------------------------------------------------------- reads


def _to_bytes(v):
    if v is None:
        return None
    return v if isinstance(v, bytes) else str(v).encode()


def sync_read(h, cluster_id, query, timeout_s):
    return _to_bytes(_hosts[h].sync_read(cluster_id, query, timeout_s))


def read_local(h, cluster_id, query):
    return _to_bytes(_hosts[h].read_local_node(cluster_id, query))


def stale_read(h, cluster_id, query):
    return _to_bytes(_hosts[h].stale_read(cluster_id, query))


# ----------------------------------------------- leadership / membership


def get_leader_id(h, cluster_id):
    return _hosts[h].get_leader_id(cluster_id)


def leader_transfer(h, cluster_id, target):
    _hosts[h].request_leader_transfer(cluster_id, target)


def add_node(h, cluster_id, node_id, address, timeout_s):
    _hosts[h].sync_request_add_node(
        cluster_id, node_id, address, timeout_s=timeout_s
    )


def delete_node(h, cluster_id, node_id, timeout_s):
    _hosts[h].sync_request_delete_node(
        cluster_id, node_id, timeout_s=timeout_s
    )


def add_observer(h, cluster_id, node_id, address, timeout_s):
    _hosts[h].sync_request_add_observer(
        cluster_id, node_id, address, timeout_s=timeout_s
    )


def add_witness(h, cluster_id, node_id, address, timeout_s):
    _hosts[h].sync_request_add_witness(
        cluster_id, node_id, address, timeout_s=timeout_s
    )


def get_cluster_membership(h, cluster_id):
    m = _hosts[h].get_cluster_membership(cluster_id)
    return _json.dumps(separators=(",", ":"), obj={
        "config_change_id": m.config_change_id,
        "addresses": {str(k): v for k, v in m.addresses.items()},
        "observers": {str(k): v for k, v in m.observers.items()},
        "witnesses": {str(k): v for k, v in m.witnesses.items()},
    })


def has_cluster(h, cluster_id):
    return _hosts[h].has_node(cluster_id)


def get_nodehost_info(h):
    nh = _hosts[h]
    infos = nh.get_nodehost_info()
    return _json.dumps(separators=(",", ":"), obj={
        "raft_address": nh.raft_address(),
        "cluster_info": [
            {
                "cluster_id": ci.cluster_id,
                "node_id": ci.node_id,
                "is_leader": bool(ci.is_leader),
                "config_change_index": ci.config_change_index,
                "nodes": {str(k): v for k, v in (ci.nodes or {}).items()},
            }
            for ci in infos
        ],
    })


def sync_request_snapshot(h, cluster_id, export_path, timeout_s):
    return _hosts[h].sync_request_snapshot(
        cluster_id, export_path or "", timeout_s=timeout_s
    )
)PY";

std::mutex g_init_mu;
bool g_initialized = false;
PyObject* g_glue = nullptr;  // module dict holding the glue functions

// errno-style per-thread code of the last failed call (see
// dbtpu_last_error); maintained by call_glue, which every ABI entry point
// routes through exactly once.
thread_local int g_last_error = DBTPU_OK;

void set_err(char* err, int errlen, const std::string& msg) {
  if (err && errlen > 0) std::snprintf(err, (size_t)errlen, "%s", msg.c_str());
}

// Exception type name -> ABI code (cf. binding.go getErrorCode).
int classify_exc(const std::string& type_name) {
  struct Entry {
    const char* name;
    int code;
  };
  static const Entry kTable[] = {
      {"ErrTimeout", DBTPU_ERR_TIMEOUT},
      {"ErrCanceled", DBTPU_ERR_CANCELED},
      {"ErrRejected", DBTPU_ERR_REJECTED},
      {"ErrClusterNotFound", DBTPU_ERR_CLUSTER_NOT_FOUND},
      {"ErrClusterNotReady", DBTPU_ERR_CLUSTER_NOT_READY},
      {"ErrClusterClosed", DBTPU_ERR_CLUSTER_CLOSED},
      {"ErrSystemBusy", DBTPU_ERR_SYSTEM_BUSY},
      {"ErrInvalidSession", DBTPU_ERR_INVALID_SESSION},
      {"ErrTimeoutTooSmall", DBTPU_ERR_TIMEOUT_TOO_SMALL},
      {"ErrPayloadTooBig", DBTPU_ERR_PAYLOAD_TOO_BIG},
      {"ErrSystemStopped", DBTPU_ERR_SYSTEM_STOPPED},
      {"ErrClusterAlreadyExist", DBTPU_ERR_CLUSTER_ALREADY_EXIST},
      {"ErrInvalidClusterSettings", DBTPU_ERR_INVALID_CLUSTER_SETTINGS},
      {"ErrDeadlineNotSet", DBTPU_ERR_DEADLINE_NOT_SET},
      {"ErrDirNotExist", DBTPU_ERR_DIR_NOT_EXIST},
      {"ErrDirLocked", DBTPU_ERR_DIR_LOCKED},
  };
  for (const auto& e : kTable) {
    if (type_name == e.name) return e.code;
  }
  return DBTPU_ERR;
}

// Fetch the current Python exception as (code, message) and clear it.
int fetch_exc(std::string* out) {
  PyObject *type = nullptr, *value = nullptr, *tb = nullptr;
  PyErr_Fetch(&type, &value, &tb);
  PyErr_NormalizeException(&type, &value, &tb);
  *out = "unknown python error";
  int code = DBTPU_ERR;
  std::string type_name;
  if (type) {
    PyObject* tn = PyObject_GetAttrString(type, "__name__");
    if (tn) {
      const char* tc = PyUnicode_AsUTF8(tn);
      if (tc) type_name = tc;
      Py_DECREF(tn);
    }
  }
  if (value) {
    PyObject* s = PyObject_Str(value);
    if (s) {
      const char* c = PyUnicode_AsUTF8(s);
      if (c) {
        *out = type_name.empty() ? c : type_name + ": " + c;
      }
      Py_DECREF(s);
    }
  }
  if (!type_name.empty()) code = classify_exc(type_name);
  Py_XDECREF(type);
  Py_XDECREF(value);
  Py_XDECREF(tb);
  return code;
}

// RAII GIL holder for calls from arbitrary C threads.
class Gil {
 public:
  Gil() : state_(PyGILState_Ensure()) {}
  ~Gil() { PyGILState_Release(state_); }

 private:
  PyGILState_STATE state_;
};

// Call glue function `name` with args tuple; returns new ref or null
// (error code via return of *code, message in *errmsg).
PyObject* call_glue(const char* name, PyObject* args, std::string* errmsg,
                    int* code) {
  g_last_error = DBTPU_OK;
  if (!args) {
    // Py_BuildValue failed (bad UTF-8 in a string arg, OOM): report
    // instead of calling with a NULL tuple
    *code = PyErr_Occurred() ? fetch_exc(errmsg) : DBTPU_ERR;
    if (*code == DBTPU_ERR && errmsg->empty()) {
      *errmsg = "argument marshalling failed";
    }
    g_last_error = *code;
    return nullptr;
  }
  PyObject* fn = PyDict_GetItemString(g_glue, name);  // borrowed
  if (!fn) {
    *errmsg = std::string("glue function missing: ") + name;
    *code = DBTPU_ERR;
    g_last_error = *code;
    return nullptr;
  }
  PyObject* ret = PyObject_CallObject(fn, args);
  if (!ret) g_last_error = *code = fetch_exc(errmsg);
  return ret;
}

// Shared skeleton: call glue, discard the result, return rc.
int call_glue_void(const char* name, PyObject* args, char* err, int errlen) {
  std::string msg;
  int code = DBTPU_ERR;
  PyObject* ret = call_glue(name, args, &msg, &code);
  Py_XDECREF(args);
  if (!ret) {
    set_err(err, errlen, msg);
    return code;
  }
  Py_DECREF(ret);
  return DBTPU_OK;
}

// Shared skeleton: call glue expecting a u64 handle/result.
uint64_t call_glue_u64(const char* name, PyObject* args, char* err,
                       int errlen) {
  std::string msg;
  int code = DBTPU_ERR;
  PyObject* ret = call_glue(name, args, &msg, &code);
  Py_XDECREF(args);
  if (!ret) {
    set_err(err, errlen, msg);
    return 0;
  }
  uint64_t v = PyLong_AsUnsignedLongLong(ret);
  Py_DECREF(ret);
  return v;
}

// Shared skeleton: glue returns bytes-or-None; marshal into a malloc'd
// buffer for the caller.
int call_glue_bytes(const char* name, PyObject* args, uint8_t** out,
                    size_t* outlen, char* err, int errlen) {
  std::string msg;
  int code = DBTPU_ERR;
  PyObject* ret = call_glue(name, args, &msg, &code);
  Py_XDECREF(args);
  if (!ret) {
    set_err(err, errlen, msg);
    return code;
  }
  *out = nullptr;
  *outlen = 0;
  if (ret != Py_None) {
    char* buf = nullptr;
    Py_ssize_t n = 0;
    if (PyBytes_AsStringAndSize(ret, &buf, &n) == 0) {
      *out = (uint8_t*)::malloc(n ? (size_t)n : 1);
      std::memcpy(*out, buf, (size_t)n);
      *outlen = (size_t)n;
    }
  }
  Py_DECREF(ret);
  return DBTPU_OK;
}

// Shared skeleton: glue returns a str; marshal to malloc'd C string.
int call_glue_str(const char* name, PyObject* args, char** out, char* err,
                  int errlen) {
  std::string msg;
  int code = DBTPU_ERR;
  PyObject* ret = call_glue(name, args, &msg, &code);
  Py_XDECREF(args);
  if (!ret) {
    set_err(err, errlen, msg);
    return code;
  }
  int rc = DBTPU_OK;
  const char* c = PyUnicode_AsUTF8(ret);
  if (c) {
    *out = ::strdup(c);
  } else {
    PyErr_Clear();
    rc = DBTPU_ERR;
    set_err(err, errlen, "non-string glue result");
  }
  Py_DECREF(ret);
  return rc;
}

// ---------------------------------------------------------------- events
// dbtpu_request_on_complete hands the glue a Python callable that invokes
// the caller's C function pointer. The callable is a PyCFunction bound to
// a capsule carrying {cb, ctx}.

struct EventCtx {
  dbtpu_event_fn cb;
  void* ctx;
};

void event_capsule_free(PyObject* cap) {
  auto* ec =
      static_cast<EventCtx*>(PyCapsule_GetPointer(cap, "dbtpu_event"));
  delete ec;
}

PyObject* invoke_event(PyObject* self, PyObject* args) {
  auto* ec =
      static_cast<EventCtx*>(PyCapsule_GetPointer(self, "dbtpu_event"));
  int code = 0;
  unsigned long long result = 0;
  if (!PyArg_ParseTuple(args, "iK", &code, &result)) return nullptr;
  dbtpu_event_fn cb = ec->cb;
  void* ctx = ec->ctx;
  // the C callback must not hold the GIL: it may block or re-enter other
  // ABI calls
  Py_BEGIN_ALLOW_THREADS;
  cb(ctx, code, (uint64_t)result);
  Py_END_ALLOW_THREADS;
  Py_RETURN_NONE;
}

PyMethodDef g_invoke_event_def = {"_dbtpu_invoke_event", invoke_event,
                                  METH_VARARGS, nullptr};

}  // namespace

extern "C" {

int dbtpu_init(void) {
  std::lock_guard<std::mutex> g(g_init_mu);
  if (g_initialized) return 0;
  bool we_initialized = false;
  if (!Py_IsInitialized()) {
    Py_InitializeEx(0);
    we_initialized = true;
  }
  PyGILState_STATE st = PyGILState_Ensure();
  PyObject* mod = PyImport_AddModule("_dbtpu_embed");  // borrowed
  if (!mod) {
    std::string msg;
    fetch_exc(&msg);
    std::fprintf(stderr, "dbtpu_init: %s\n", msg.c_str());
    PyGILState_Release(st);
    return -1;
  }
  PyObject* dict = PyModule_GetDict(mod);  // borrowed
  // PyRun_String auto-inserts __builtins__ into bare globals
  PyObject* res = PyRun_String(_GLUE, Py_file_input, dict, dict);
  int rc = 0;
  if (!res) {
    std::string msg;
    fetch_exc(&msg);
    std::fprintf(stderr, "dbtpu_init: %s\n", msg.c_str());
    rc = -1;
  } else {
    Py_DECREF(res);
    g_glue = dict;
    Py_INCREF(g_glue);
    g_initialized = true;
  }
  PyGILState_Release(st);
  if (rc == 0 && we_initialized) {
    // We own the interpreter: Py_InitializeEx left this thread holding
    // the GIL, release it so framework threads run between C calls. When
    // the host app already embeds Python, its GIL discipline is left
    // untouched (PyGILState_Release above restored the prior state).
    PyEval_SaveThread();
  }
  return rc;
}

int dbtpu_last_error(void) { return g_last_error; }

void dbtpu_finalize(void) {
  std::lock_guard<std::mutex> g(g_init_mu);
  if (!g_initialized) return;
  // NOTE: the framework owns daemon threads; a full Py_Finalize from an
  // embedder is unsafe while NodeHosts run. Stop hosts first.
  g_initialized = false;
}

dbtpu_nodehost dbtpu_nodehost_new(const char* config_json, char* err,
                                  int errlen) {
  Gil gil;
  return call_glue_u64("new_nodehost", Py_BuildValue("(s)", config_json),
                       err, errlen);
}

int dbtpu_nodehost_stop(dbtpu_nodehost nh, char* err, int errlen) {
  Gil gil;
  return call_glue_void("stop_nodehost",
                        Py_BuildValue("(K)", (unsigned long long)nh), err,
                        errlen);
}

int dbtpu_start_cluster(dbtpu_nodehost nh, const char* members_json,
                        int join, const char* plugin_path,
                        const char* cluster_config_json, char* err,
                        int errlen) {
  Gil gil;
  return call_glue_void(
      "start_cluster",
      Py_BuildValue("(Ksiss)", (unsigned long long)nh, members_json, join,
                    plugin_path, cluster_config_json),
      err, errlen);
}

int dbtpu_stop_cluster(dbtpu_nodehost nh, uint64_t cluster_id, char* err,
                       int errlen) {
  Gil gil;
  return call_glue_void("stop_cluster",
                        Py_BuildValue("(KK)", (unsigned long long)nh,
                                      (unsigned long long)cluster_id),
                        err, errlen);
}

// ------------------------------------------------------------- sessions

dbtpu_session dbtpu_session_noop(dbtpu_nodehost nh, uint64_t cluster_id,
                                 char* err, int errlen) {
  Gil gil;
  return call_glue_u64("session_noop",
                       Py_BuildValue("(KK)", (unsigned long long)nh,
                                     (unsigned long long)cluster_id),
                       err, errlen);
}

dbtpu_session dbtpu_session_open(dbtpu_nodehost nh, uint64_t cluster_id,
                                 double timeout_s, char* err, int errlen) {
  Gil gil;
  return call_glue_u64("session_open",
                       Py_BuildValue("(KKd)", (unsigned long long)nh,
                                     (unsigned long long)cluster_id,
                                     timeout_s),
                       err, errlen);
}

int dbtpu_session_close(dbtpu_nodehost nh, dbtpu_session s,
                        double timeout_s, char* err, int errlen) {
  Gil gil;
  return call_glue_void("session_close",
                        Py_BuildValue("(KKd)", (unsigned long long)nh,
                                      (unsigned long long)s, timeout_s),
                        err, errlen);
}

int dbtpu_session_proposal_completed(dbtpu_nodehost nh, dbtpu_session s,
                                     char* err, int errlen) {
  Gil gil;
  return call_glue_void("session_proposal_completed",
                        Py_BuildValue("(KK)", (unsigned long long)nh,
                                      (unsigned long long)s),
                        err, errlen);
}

void dbtpu_session_release(dbtpu_nodehost nh, dbtpu_session s) {
  Gil gil;
  call_glue_void("session_release",
                 Py_BuildValue("(KK)", (unsigned long long)nh,
                               (unsigned long long)s),
                 nullptr, 0);
}

// ------------------------------------------------------------ proposals

int dbtpu_sync_propose(dbtpu_nodehost nh, uint64_t cluster_id,
                       const uint8_t* cmd, size_t cmdlen, double timeout_s,
                       uint64_t* result, char* err, int errlen) {
  Gil gil;
  std::string msg;
  int code = DBTPU_ERR;
  PyObject* args = Py_BuildValue(
      "(KKy#d)", (unsigned long long)nh, (unsigned long long)cluster_id,
      (const char*)cmd, (Py_ssize_t)cmdlen, timeout_s);
  PyObject* ret = call_glue("sync_propose", args, &msg, &code);
  Py_XDECREF(args);
  if (!ret) {
    set_err(err, errlen, msg);
    return code;
  }
  if (result) *result = PyLong_AsUnsignedLongLong(ret);
  Py_DECREF(ret);
  return DBTPU_OK;
}

int dbtpu_sync_propose_session(dbtpu_nodehost nh, dbtpu_session s,
                               const uint8_t* cmd, size_t cmdlen,
                               double timeout_s, uint64_t* result,
                               char* err, int errlen) {
  Gil gil;
  std::string msg;
  int code = DBTPU_ERR;
  PyObject* args = Py_BuildValue(
      "(KKy#d)", (unsigned long long)nh, (unsigned long long)s,
      (const char*)cmd, (Py_ssize_t)cmdlen, timeout_s);
  PyObject* ret = call_glue("sync_propose_session", args, &msg, &code);
  Py_XDECREF(args);
  if (!ret) {
    set_err(err, errlen, msg);
    return code;
  }
  if (result) *result = PyLong_AsUnsignedLongLong(ret);
  Py_DECREF(ret);
  return DBTPU_OK;
}

dbtpu_request dbtpu_propose(dbtpu_nodehost nh, dbtpu_session s,
                            const uint8_t* cmd, size_t cmdlen,
                            double timeout_s, char* err, int errlen) {
  Gil gil;
  return call_glue_u64(
      "propose",
      Py_BuildValue("(KKy#d)", (unsigned long long)nh,
                    (unsigned long long)s, (const char*)cmd,
                    (Py_ssize_t)cmdlen, timeout_s),
      err, errlen);
}

dbtpu_request dbtpu_read_index(dbtpu_nodehost nh, uint64_t cluster_id,
                               double timeout_s, char* err, int errlen) {
  Gil gil;
  return call_glue_u64("read_index",
                       Py_BuildValue("(KKd)", (unsigned long long)nh,
                                     (unsigned long long)cluster_id,
                                     timeout_s),
                       err, errlen);
}

namespace {

// Shared tail for request_wait / request_poll: glue returns None (still
// pending) or a (code, result) tuple.
int finish_request_ret(PyObject* ret, int* done, int* code,
                       uint64_t* result, char* err, int errlen) {
  if (ret == Py_None) {
    if (done) *done = 0;
    Py_DECREF(ret);
    return DBTPU_OK;
  }
  int c = 0;
  unsigned long long v = 0;
  if (!PyArg_ParseTuple(ret, "iK", &c, &v)) {
    Py_DECREF(ret);
    std::string msg;
    int ec = fetch_exc(&msg);
    set_err(err, errlen, msg);
    return ec;
  }
  Py_DECREF(ret);
  if (done) *done = 1;
  if (code) *code = c;
  if (result) *result = v;
  return DBTPU_OK;
}

}  // namespace

int dbtpu_request_wait(dbtpu_nodehost nh, dbtpu_request r, double wait_s,
                       int* code, uint64_t* result, char* err, int errlen) {
  std::string msg;
  int ec = DBTPU_ERR;
  PyObject* ret = nullptr;
  {
    Gil gil;
    PyObject* args = Py_BuildValue("(KKd)", (unsigned long long)nh,
                                   (unsigned long long)r, wait_s);
    // RequestState.wait releases the GIL internally (threading.Event)
    ret = call_glue("request_wait", args, &msg, &ec);
    Py_XDECREF(args);
  }
  if (!ret) {
    set_err(err, errlen, msg);
    return ec;
  }
  Gil gil;
  int done = 1;
  int rc = finish_request_ret(ret, &done, code, result, err, errlen);
  if (rc == DBTPU_OK && !done) return DBTPU_ERR_TIMEOUT;  // handle live
  return rc;
}

int dbtpu_request_poll(dbtpu_nodehost nh, dbtpu_request r, int* done,
                       int* code, uint64_t* result, char* err, int errlen) {
  Gil gil;
  std::string msg;
  int ec = DBTPU_ERR;
  PyObject* args =
      Py_BuildValue("(KK)", (unsigned long long)nh, (unsigned long long)r);
  PyObject* ret = call_glue("request_poll", args, &msg, &ec);
  Py_XDECREF(args);
  if (!ret) {
    set_err(err, errlen, msg);
    return ec;
  }
  return finish_request_ret(ret, done, code, result, err, errlen);
}

int dbtpu_request_on_complete(dbtpu_nodehost nh, dbtpu_request r,
                              dbtpu_event_fn cb, void* ctx, char* err,
                              int errlen) {
  Gil gil;
  auto* ec = new EventCtx{cb, ctx};
  PyObject* cap = PyCapsule_New(ec, "dbtpu_event", event_capsule_free);
  if (!cap) {
    delete ec;
    set_err(err, errlen, "capsule allocation failed");
    return DBTPU_ERR;
  }
  PyObject* fn = PyCFunction_New(&g_invoke_event_def, cap);
  Py_DECREF(cap);  // fn owns it now
  if (!fn) {
    set_err(err, errlen, "callable allocation failed");
    return DBTPU_ERR;
  }
  std::string msg;
  int code = DBTPU_ERR;
  PyObject* args = Py_BuildValue("(KKO)", (unsigned long long)nh,
                                 (unsigned long long)r, fn);
  PyObject* ret = call_glue("request_on_complete", args, &msg, &code);
  Py_XDECREF(args);
  Py_DECREF(fn);
  if (!ret) {
    set_err(err, errlen, msg);
    return code;
  }
  Py_DECREF(ret);
  return DBTPU_OK;
}

void dbtpu_request_release(dbtpu_nodehost nh, dbtpu_request r) {
  Gil gil;
  call_glue_void("request_release",
                 Py_BuildValue("(KK)", (unsigned long long)nh,
                               (unsigned long long)r),
                 nullptr, 0);
}

// ---------------------------------------------------------------- reads

int dbtpu_sync_read(dbtpu_nodehost nh, uint64_t cluster_id,
                    const uint8_t* query, size_t querylen, double timeout_s,
                    uint8_t** out, size_t* outlen, char* err, int errlen) {
  Gil gil;
  return call_glue_bytes(
      "sync_read",
      Py_BuildValue("(KKy#d)", (unsigned long long)nh,
                    (unsigned long long)cluster_id, (const char*)query,
                    (Py_ssize_t)querylen, timeout_s),
      out, outlen, err, errlen);
}

int dbtpu_read_local(dbtpu_nodehost nh, uint64_t cluster_id,
                     const uint8_t* query, size_t querylen, uint8_t** out,
                     size_t* outlen, char* err, int errlen) {
  Gil gil;
  return call_glue_bytes(
      "read_local",
      Py_BuildValue("(KKy#)", (unsigned long long)nh,
                    (unsigned long long)cluster_id, (const char*)query,
                    (Py_ssize_t)querylen),
      out, outlen, err, errlen);
}

int dbtpu_stale_read(dbtpu_nodehost nh, uint64_t cluster_id,
                     const uint8_t* query, size_t querylen, uint8_t** out,
                     size_t* outlen, char* err, int errlen) {
  Gil gil;
  return call_glue_bytes(
      "stale_read",
      Py_BuildValue("(KKy#)", (unsigned long long)nh,
                    (unsigned long long)cluster_id, (const char*)query,
                    (Py_ssize_t)querylen),
      out, outlen, err, errlen);
}

// ----------------------------------------------------------- leadership

int dbtpu_get_leader_id(dbtpu_nodehost nh, uint64_t cluster_id,
                        uint64_t* leader_id, int* has_leader, char* err,
                        int errlen) {
  Gil gil;
  std::string msg;
  int code = DBTPU_ERR;
  PyObject* args = Py_BuildValue("(KK)", (unsigned long long)nh,
                                 (unsigned long long)cluster_id);
  PyObject* ret = call_glue("get_leader_id", args, &msg, &code);
  Py_XDECREF(args);
  if (!ret) {
    set_err(err, errlen, msg);
    return code;
  }
  unsigned long long lid = 0;
  int ok = 0;
  if (!PyArg_ParseTuple(ret, "Kp", &lid, &ok)) {
    Py_DECREF(ret);
    int ec = fetch_exc(&msg);
    set_err(err, errlen, msg);
    return ec;
  }
  Py_DECREF(ret);
  if (leader_id) *leader_id = lid;
  if (has_leader) *has_leader = ok;
  return DBTPU_OK;
}

int dbtpu_request_leader_transfer(dbtpu_nodehost nh, uint64_t cluster_id,
                                  uint64_t target_node_id, char* err,
                                  int errlen) {
  Gil gil;
  return call_glue_void(
      "leader_transfer",
      Py_BuildValue("(KKK)", (unsigned long long)nh,
                    (unsigned long long)cluster_id,
                    (unsigned long long)target_node_id),
      err, errlen);
}

// ----------------------------------------------------------- membership

int dbtpu_sync_add_node(dbtpu_nodehost nh, uint64_t cluster_id,
                        uint64_t node_id, const char* address,
                        double timeout_s, char* err, int errlen) {
  Gil gil;
  return call_glue_void(
      "add_node",
      Py_BuildValue("(KKKsd)", (unsigned long long)nh,
                    (unsigned long long)cluster_id,
                    (unsigned long long)node_id, address, timeout_s),
      err, errlen);
}

int dbtpu_sync_delete_node(dbtpu_nodehost nh, uint64_t cluster_id,
                           uint64_t node_id, double timeout_s, char* err,
                           int errlen) {
  Gil gil;
  return call_glue_void(
      "delete_node",
      Py_BuildValue("(KKKd)", (unsigned long long)nh,
                    (unsigned long long)cluster_id,
                    (unsigned long long)node_id, timeout_s),
      err, errlen);
}

int dbtpu_sync_add_observer(dbtpu_nodehost nh, uint64_t cluster_id,
                            uint64_t node_id, const char* address,
                            double timeout_s, char* err, int errlen) {
  Gil gil;
  return call_glue_void(
      "add_observer",
      Py_BuildValue("(KKKsd)", (unsigned long long)nh,
                    (unsigned long long)cluster_id,
                    (unsigned long long)node_id, address, timeout_s),
      err, errlen);
}

int dbtpu_sync_add_witness(dbtpu_nodehost nh, uint64_t cluster_id,
                           uint64_t node_id, const char* address,
                           double timeout_s, char* err, int errlen) {
  Gil gil;
  return call_glue_void(
      "add_witness",
      Py_BuildValue("(KKKsd)", (unsigned long long)nh,
                    (unsigned long long)cluster_id,
                    (unsigned long long)node_id, address, timeout_s),
      err, errlen);
}

int dbtpu_get_cluster_membership(dbtpu_nodehost nh, uint64_t cluster_id,
                                 char** json_out, char* err, int errlen) {
  Gil gil;
  return call_glue_str("get_cluster_membership",
                       Py_BuildValue("(KK)", (unsigned long long)nh,
                                     (unsigned long long)cluster_id),
                       json_out, err, errlen);
}

int dbtpu_has_cluster(dbtpu_nodehost nh, uint64_t cluster_id) {
  Gil gil;
  std::string msg;
  int code = DBTPU_ERR;
  PyObject* args = Py_BuildValue("(KK)", (unsigned long long)nh,
                                 (unsigned long long)cluster_id);
  PyObject* ret = call_glue("has_cluster", args, &msg, &code);
  Py_XDECREF(args);
  if (!ret) return 0;
  int v = PyObject_IsTrue(ret);
  Py_DECREF(ret);
  return v == 1 ? 1 : 0;
}

int dbtpu_get_nodehost_info(dbtpu_nodehost nh, char** json_out, char* err,
                            int errlen) {
  Gil gil;
  return call_glue_str("get_nodehost_info",
                       Py_BuildValue("(K)", (unsigned long long)nh),
                       json_out, err, errlen);
}

// ------------------------------------------------------------ snapshots

int dbtpu_sync_request_snapshot(dbtpu_nodehost nh, uint64_t cluster_id,
                                const char* export_path, double timeout_s,
                                uint64_t* index, char* err, int errlen) {
  Gil gil;
  std::string msg;
  int code = DBTPU_ERR;
  PyObject* args = Py_BuildValue(
      "(KKsd)", (unsigned long long)nh, (unsigned long long)cluster_id,
      export_path ? export_path : "", timeout_s);
  PyObject* ret = call_glue("sync_request_snapshot", args, &msg, &code);
  Py_XDECREF(args);
  if (!ret) {
    set_err(err, errlen, msg);
    return code;
  }
  if (index) *index = PyLong_AsUnsignedLongLong(ret);
  Py_DECREF(ret);
  return DBTPU_OK;
}

void dbtpu_free(void* p) { ::free(p); }

}  // extern "C"
