/* Native hot path for the columnar scheduler commit.
 *
 * The TPU kernel plans a 100k-task group in ~0.1s; the Python loops that
 * clone Task objects and commit them to the store were ~10us/task and
 * dominated end-to-end throughput (see BASELINE.md).  This module moves
 * exactly those two loops to C:
 *
 *   plan_apply     - clone-and-register the planner's per-task decisions
 *                    (replaces ops/planner.py's apply loop body)
 *   commit_prepare - validate + version-check + stamp one commit chunk
 *                    (replaces the per-task half of store.bulk_update_tasks)
 *   commit_apply   - install stamped tasks into the store table + indexes
 *
 * The columnar commit plane (ISSUE 13) extends the seam to the other
 * side of consensus and to watch delivery:
 *
 *   block_decode         - parse the compact binary task-block raft
 *                          entry (serde.BLOCK_ENTRY_MAGIC) into a
 *                          TaskBlockAction; the byte scan runs with the
 *                          GIL released
 *   block_apply_follower - follower-side apply of a decoded block into
 *                          the task overlay + by_node index, one batched
 *                          index pass per chunk
 *   fanout_expand        - synthesize the per-task watch Events of one
 *                          EventTaskBlock (the Python oracle is
 *                          events.EventTaskBlock.expand_events)
 *   fanout_filter        - per-subscriber predicate pre-filter over an
 *                          expanded event list
 *   per_node_group       - node_id -> [(old, version)] grouping for
 *                          block-aware dispatcher sessions
 *
 * Semantics are identical to the pure-Python implementations, which remain
 * as fallbacks (and as the differential-test oracle).  The reference has no
 * native code (SURVEY.md section 2); this is a deliberate tpu-framework
 * improvement, not parity work.
 *
 * All objects handled here are plain-dict Python instances following the
 * store's replace-don't-mutate convention, so a shallow __dict__ copy plus
 * targeted overrides reproduces Task.copy()/Meta.copy() exactly.
 */
#define PY_SSIZE_T_CLEAN
#include <Python.h>
#include <stdint.h>
#include <string.h>

static PyObject *s_dict, *s_meta, *s_version, *s_index, *s_created_at,
    *s_updated_at, *s_status, *s_node_id, *s_networks, *s_volumes, *s_agr,
    *s_id, *s_state, *s_message, *s_err, *s_service_id, *s_slot, *s_old,
    *s_new, *s_update, *s_task_block;
static PyObject *empty_tuple;

static PyObject *
new_instance(PyTypeObject *tp)
{
    return tp->tp_new(tp, empty_tuple, NULL);
}

/* Fresh instance of type(obj) with a copy of obj.__dict__.  If out_dict is
 * non-NULL it receives a NEW reference to the copied dict (mutating it
 * mutates the clone's attributes). */
static PyObject *
shallow_clone(PyObject *obj, PyObject **out_dict)
{
    PyTypeObject *tp = Py_TYPE(obj);
    PyObject *nobj = new_instance(tp);
    if (!nobj)
        return NULL;
    PyObject *od = PyObject_GetAttr(obj, s_dict);
    if (!od)
        goto fail;
    PyObject *d = PyDict_Copy(od);
    Py_DECREF(od);
    if (!d)
        goto fail;
    if (PyObject_SetAttr(nobj, s_dict, d) < 0) {
        Py_DECREF(d);
        goto fail;
    }
    if (out_dict)
        *out_dict = d; /* transfer our reference */
    else
        Py_DECREF(d);
    return nobj;
fail:
    Py_DECREF(nobj);
    return NULL;
}

/* Meta copy: clone meta and its nested Version (objects.py Meta.copy). */
static PyObject *
clone_meta(PyObject *meta)
{
    PyObject *md = NULL;
    PyObject *nm = shallow_clone(meta, &md);
    if (!nm)
        return NULL;
    PyObject *ver = PyDict_GetItem(md, s_version); /* borrowed */
    if (ver) {
        PyObject *nv = shallow_clone(ver, NULL);
        if (!nv) {
            Py_DECREF(md);
            Py_DECREF(nm);
            return NULL;
        }
        if (PyDict_SetItem(md, s_version, nv) < 0) {
            Py_DECREF(nv);
            Py_DECREF(md);
            Py_DECREF(nm);
            return NULL;
        }
        Py_DECREF(nv);
    }
    Py_DECREF(md);
    return nm;
}

/* Replace d[key] (a list) with a shallow copy of it. */
static int
copy_list_field(PyObject *d, PyObject *key)
{
    PyObject *lst = PyDict_GetItem(d, key);
    if (!lst)
        return 0;
    PyObject *c = PySequence_List(lst);
    if (!c)
        return -1;
    int r = PyDict_SetItem(d, key, c);
    Py_DECREF(c);
    return r;
}

/* plan_apply(items, slots, node_ids_by_node, task_dicts_by_node,
 *            shared_status, all_tasks, decisions, decision_cls) -> None
 *
 * items: list of (task_id, Task) pairs; slots: list of int node indices
 * (aligned with items); node_ids_by_node / task_dicts_by_node: per-*node*
 * lookup tables (id string, NodeInfo.tasks dict).  For each i: clone
 * items[i]'s task as an ASSIGNED task on node slots[i], register it in
 * all_tasks and that node's task map, and store decision_cls(old, new) in
 * decisions keyed by task id.  min(len(items), len(slots)) entries are
 * processed — slots may be shorter when the group did not fully fit.
 */
static PyObject *
plan_apply(PyObject *self, PyObject *args)
{
    PyObject *items, *slots, *node_ids, *task_dicts, *status, *all_tasks,
        *decisions, *decision_cls;
    if (!PyArg_ParseTuple(args, "OOOOOOOO", &items, &slots, &node_ids,
                          &task_dicts, &status, &all_tasks, &decisions,
                          &decision_cls))
        return NULL;
    if (!PyList_Check(items) || !PyList_Check(slots) ||
        !PyList_Check(node_ids) || !PyList_Check(task_dicts)) {
        PyErr_SetString(PyExc_TypeError, "expected lists");
        return NULL;
    }
    Py_ssize_t n = PyList_GET_SIZE(items);
    Py_ssize_t ns = PyList_GET_SIZE(slots);
    if (ns < n)
        n = ns;
    Py_ssize_t n_nodes = PyList_GET_SIZE(node_ids);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *pair = PyList_GET_ITEM(items, i);
        if (!PyTuple_Check(pair) || PyTuple_GET_SIZE(pair) != 2) {
            PyErr_SetString(PyExc_TypeError, "items must be (id, task)");
            return NULL;
        }
        PyObject *old = PyTuple_GET_ITEM(pair, 1);
        Py_ssize_t ni = PyLong_AsSsize_t(PyList_GET_ITEM(slots, i));
        if (ni < 0 || ni >= n_nodes) {
            if (!PyErr_Occurred())
                PyErr_SetString(PyExc_IndexError, "slot out of range");
            return NULL;
        }
        PyObject *nid = PyList_GET_ITEM(node_ids, ni);
        PyObject *idict = PyList_GET_ITEM(task_dicts, ni);
        PyObject *d = NULL;
        PyObject *nt = shallow_clone(old, &d);
        if (!nt)
            return NULL;
        PyObject *meta = PyDict_GetItem(d, s_meta);
        if (meta) {
            PyObject *nm = clone_meta(meta);
            if (!nm)
                goto item_fail;
            if (PyDict_SetItem(d, s_meta, nm) < 0) {
                Py_DECREF(nm);
                goto item_fail;
            }
            Py_DECREF(nm);
        }
        if (PyDict_SetItem(d, s_status, status) < 0 ||
            PyDict_SetItem(d, s_node_id, nid) < 0 ||
            copy_list_field(d, s_networks) < 0 ||
            copy_list_field(d, s_volumes) < 0)
            goto item_fail;
        PyObject *empty = PyList_New(0);
        if (!empty || PyDict_SetItem(d, s_agr, empty) < 0) {
            Py_XDECREF(empty);
            goto item_fail;
        }
        Py_DECREF(empty);
        PyObject *tid = PyDict_GetItem(d, s_id);
        if (!tid) {
            PyErr_SetString(PyExc_AttributeError, "task has no id");
            goto item_fail;
        }
        if (PyDict_SetItem(all_tasks, tid, nt) < 0 ||
            PyDict_SetItem(idict, tid, nt) < 0)
            goto item_fail;
        PyObject *dec = new_instance((PyTypeObject *)decision_cls);
        if (!dec)
            goto item_fail;
        if (PyObject_SetAttr(dec, s_old, old) < 0 ||
            PyObject_SetAttr(dec, s_new, nt) < 0 ||
            PyDict_SetItem(decisions, tid, dec) < 0) {
            Py_DECREF(dec);
            goto item_fail;
        }
        Py_DECREF(dec);
        Py_DECREF(d);
        Py_DECREF(nt);
        continue;
    item_fail:
        Py_XDECREF(d);
        Py_DECREF(nt);
        return NULL;
    }
    Py_RETURN_NONE;
}

/* block_stage(items, slots, node_ids_by_node, task_dicts_by_node)
 *   -> (olds, nids)
 *
 * Columnar staging of a planned group for the block-commit path: for each
 * of the min(len(items), len(slots)) placements, plant the (unmodified)
 * mirror task into its node's NodeInfo.tasks dict and emit parallel
 * olds/nids columns ready for MemoryStore.commit_task_block.  No task
 * objects are built — this replaces a per-task Python loop that allocated
 * a 3-tuple per placement (ops/planner.py block-mode apply).
 */
static PyObject *
block_stage(PyObject *self, PyObject *args)
{
    PyObject *items, *slots, *node_ids, *task_dicts;
    if (!PyArg_ParseTuple(args, "O!O!O!O!", &PyList_Type, &items,
                          &PyList_Type, &slots, &PyList_Type, &node_ids,
                          &PyList_Type, &task_dicts))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(items);
    Py_ssize_t ns = PyList_GET_SIZE(slots);
    if (ns < n)
        n = ns;
    Py_ssize_t n_nodes = PyList_GET_SIZE(node_ids);
    PyObject *olds = PyList_New(n);
    PyObject *nids = PyList_New(n);
    if (!olds || !nids)
        goto fail;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *pair = PyList_GET_ITEM(items, i);
        if (!PyTuple_Check(pair) || PyTuple_GET_SIZE(pair) != 2) {
            PyErr_SetString(PyExc_TypeError, "items must be (id, task)");
            goto fail;
        }
        PyObject *tid = PyTuple_GET_ITEM(pair, 0);
        PyObject *task = PyTuple_GET_ITEM(pair, 1);
        Py_ssize_t ni = PyLong_AsSsize_t(PyList_GET_ITEM(slots, i));
        if (ni < 0 || ni >= n_nodes) {
            if (!PyErr_Occurred())
                PyErr_SetString(PyExc_IndexError, "slot out of range");
            goto fail;
        }
        PyObject *nid = PyList_GET_ITEM(node_ids, ni);
        PyObject *tdict = PyList_GET_ITEM(task_dicts, ni);
        if (PyDict_SetItem(tdict, tid, task) < 0)
            goto fail;
        Py_INCREF(task);
        PyList_SET_ITEM(olds, i, task);
        Py_INCREF(nid);
        PyList_SET_ITEM(nids, i, nid);
    }
    {
        PyObject *out = PyTuple_Pack(2, olds, nids);
        Py_DECREF(olds);
        Py_DECREF(nids);
        return out;
    }
fail:
    Py_XDECREF(olds);
    Py_XDECREF(nids);
    return NULL;
}

/* commit_prepare(new_tasks, start, stop, objects, seq_start, ts,
 *                guard_state, action_cls_or_None, event_cls_or_None,
 *                on_missing, on_assigned)
 *   -> (committed_idx, failed_idx, stamped, actions_or_None, events_or_None)
 *
 * Mirrors the validation half of MemoryStore.bulk_update_tasks:
 *   - missing stored object        -> on_missing(new), skip
 *   - status unchanged             -> skip
 *   - stored state >= guard_state  -> on_assigned(new) False => fail
 *   - version mismatch             -> fail (SequenceConflict semantics)
 *   - otherwise stamp version/timestamps and collect
 */
static PyObject *
commit_prepare(PyObject *self, PyObject *args)
{
    PyObject *new_tasks, *objects, *action_cls, *event_cls, *on_missing,
        *on_assigned, *guard_state;
    Py_ssize_t start, stop;
    long long seq;
    double ts;
    if (!PyArg_ParseTuple(args, "OnnOLdOOOOO", &new_tasks, &start, &stop,
                          &objects, &seq, &ts, &guard_state, &action_cls,
                          &event_cls, &on_missing, &on_assigned))
        return NULL;

    int want_actions = action_cls != Py_None;
    int want_events = event_cls != Py_None;
    PyObject *committed = PyList_New(0);
    PyObject *failed = PyList_New(0);
    PyObject *stamped = PyList_New(0);
    PyObject *actions = want_actions ? PyList_New(0) : Py_NewRef(Py_None);
    PyObject *events = want_events ? PyList_New(0) : Py_NewRef(Py_None);
    PyObject *ts_obj = PyFloat_FromDouble(ts);
    if (!committed || !failed || !stamped || !actions || !events || !ts_obj)
        goto fail;

    for (Py_ssize_t i = start; i < stop; i++) {
        PyObject *nt = PyList_GET_ITEM(new_tasks, i);
        PyObject *nd = PyObject_GetAttr(nt, s_dict);
        if (!nd)
            goto fail;
        PyObject *tid = PyDict_GetItem(nd, s_id);
        PyObject *cur = tid ? PyDict_GetItem(objects, tid) : NULL;
        if (!cur) {
            Py_DECREF(nd);
            PyObject *r = PyObject_CallOneArg(on_missing, nt);
            if (!r)
                goto fail;
            Py_DECREF(r);
            continue;
        }
        PyObject *cd = PyObject_GetAttr(cur, s_dict);
        if (!cd) {
            Py_DECREF(nd);
            goto fail;
        }
        /* status equality (state, message, err) */
        PyObject *cstat = PyDict_GetItem(cd, s_status);
        PyObject *nstat = PyDict_GetItem(nd, s_status);
        int skip = 0, failed_item = 0;
        PyObject *cs_state = NULL;
        if (cstat && nstat) {
            PyObject *csd = PyObject_GetAttr(cstat, s_dict);
            PyObject *nsd = PyObject_GetAttr(nstat, s_dict);
            if (!csd || !nsd) {
                Py_XDECREF(csd);
                Py_XDECREF(nsd);
                Py_DECREF(cd);
                Py_DECREF(nd);
                goto fail;
            }
            cs_state = PyDict_GetItem(csd, s_state);
            Py_XINCREF(cs_state);
            int eq = 1;
            PyObject *keys[3] = {s_state, s_message, s_err};
            for (int k = 0; k < 3 && eq; k++) {
                PyObject *a = PyDict_GetItem(csd, keys[k]);
                PyObject *b = PyDict_GetItem(nsd, keys[k]);
                if (a == b)
                    continue;
                if (!a || !b) {
                    eq = 0;
                    break;
                }
                int r = PyObject_RichCompareBool(a, b, Py_EQ);
                if (r < 0) {
                    Py_DECREF(csd);
                    Py_DECREF(nsd);
                    Py_XDECREF(cs_state);
                    Py_DECREF(cd);
                    Py_DECREF(nd);
                    goto fail;
                }
                eq = r;
            }
            Py_DECREF(csd);
            Py_DECREF(nsd);
            skip = eq;
        }
        if (!skip && cs_state) {
            int ge = PyObject_RichCompareBool(cs_state, guard_state, Py_GE);
            if (ge < 0) {
                Py_XDECREF(cs_state);
                Py_DECREF(cd);
                Py_DECREF(nd);
                goto fail;
            }
            if (ge) {
                PyObject *r = PyObject_CallOneArg(on_assigned, nt);
                if (!r) {
                    Py_XDECREF(cs_state);
                    Py_DECREF(cd);
                    Py_DECREF(nd);
                    goto fail;
                }
                int ok = PyObject_IsTrue(r);
                Py_DECREF(r);
                if (!ok)
                    failed_item = 1;
            }
        }
        Py_XDECREF(cs_state);
        if (skip) {
            Py_DECREF(cd);
            Py_DECREF(nd);
            continue;
        }
        PyObject *cmeta = PyDict_GetItem(cd, s_meta);
        PyObject *nmeta = PyDict_GetItem(nd, s_meta);
        if (!failed_item) {
            /* version check: cur.meta.version.index == new.meta.version.index */
            PyObject *cv = cmeta ? PyObject_GetAttr(cmeta, s_version) : NULL;
            PyObject *nv = nmeta ? PyObject_GetAttr(nmeta, s_version) : NULL;
            PyObject *cvi = cv ? PyObject_GetAttr(cv, s_index) : NULL;
            PyObject *nvi = nv ? PyObject_GetAttr(nv, s_index) : NULL;
            Py_XDECREF(cv);
            Py_XDECREF(nv);
            if (!cvi || !nvi) {
                Py_XDECREF(cvi);
                Py_XDECREF(nvi);
                Py_DECREF(cd);
                Py_DECREF(nd);
                goto fail;
            }
            int eq = PyObject_RichCompareBool(cvi, nvi, Py_EQ);
            Py_DECREF(cvi);
            Py_DECREF(nvi);
            if (eq < 0) {
                Py_DECREF(cd);
                Py_DECREF(nd);
                goto fail;
            }
            if (!eq)
                failed_item = 1;
        }
        if (failed_item) {
            PyObject *iobj = PyLong_FromSsize_t(i);
            int r = iobj ? PyList_Append(failed, iobj) : -1;
            Py_XDECREF(iobj);
            Py_DECREF(cd);
            Py_DECREF(nd);
            if (r < 0)
                goto fail;
            continue;
        }
        /* stamp */
        seq += 1;
        {
            PyObject *nv = PyObject_GetAttr(nmeta, s_version);
            PyObject *seq_obj = PyLong_FromLongLong(seq);
            PyObject *created = cmeta ? PyObject_GetAttr(cmeta, s_created_at)
                                      : NULL;
            int err = !nv || !seq_obj || !created ||
                      PyObject_SetAttr(nv, s_index, seq_obj) < 0 ||
                      PyObject_SetAttr(nmeta, s_created_at, created) < 0 ||
                      PyObject_SetAttr(nmeta, s_updated_at, ts_obj) < 0;
            Py_XDECREF(nv);
            Py_XDECREF(seq_obj);
            Py_XDECREF(created);
            if (err) {
                Py_DECREF(cd);
                Py_DECREF(nd);
                goto fail;
            }
        }
        PyObject *iobj = PyLong_FromSsize_t(i);
        int r = iobj ? PyList_Append(committed, iobj) : -1;
        Py_XDECREF(iobj);
        if (r < 0 || PyList_Append(stamped, nt) < 0) {
            Py_DECREF(cd);
            Py_DECREF(nd);
            goto fail;
        }
        if (want_actions) {
            PyObject *act = PyObject_CallFunctionObjArgs(action_cls, s_update,
                                                         nt, NULL);
            int ar = act ? PyList_Append(actions, act) : -1;
            Py_XDECREF(act);
            if (ar < 0) {
                Py_DECREF(cd);
                Py_DECREF(nd);
                goto fail;
            }
        }
        if (want_events) {
            PyObject *ev = PyObject_CallFunctionObjArgs(event_cls, s_update,
                                                        nt, cur, NULL);
            int er = ev ? PyList_Append(events, ev) : -1;
            Py_XDECREF(ev);
            if (er < 0) {
                Py_DECREF(cd);
                Py_DECREF(nd);
                goto fail;
            }
        }
        Py_DECREF(cd);
        Py_DECREF(nd);
    }
    Py_DECREF(ts_obj);
    PyObject *out = PyTuple_Pack(5, committed, failed, stamped, actions,
                                 events);
    Py_DECREF(committed);
    Py_DECREF(failed);
    Py_DECREF(stamped);
    Py_DECREF(actions);
    Py_DECREF(events);
    return out;
fail:
    Py_XDECREF(committed);
    Py_XDECREF(failed);
    Py_XDECREF(stamped);
    Py_XDECREF(actions);
    Py_XDECREF(events);
    Py_XDECREF(ts_obj);
    return NULL;
}

/* Equality of two borrowed dict values where either may be NULL (missing
 * key).  Returns 1/0, or -1 with an exception set.  Kept out of the `||`
 * short-circuit form: in C, `x || rich_compare()` turns an error return of
 * -1 into truthy 1, silently swallowing the pending exception. */
static int
dict_vals_equal(PyObject *a, PyObject *b)
{
    if (a == b)
        return 1;
    if (a == NULL || b == NULL)
        return 0;
    return PyObject_RichCompareBool(a, b, Py_EQ);
}

/* Index buckets are insertion-ordered {task_id: None} dicts, not sets:
 * indexed find() results feed placement decisions, and set iteration
 * order varies with hash randomization (per-process nondeterminism the
 * sim's byte-identical-report contract forbids).  Discard = guarded
 * delete; missing key is not an error (mirrors set.discard). */
static int
bucket_discard(PyObject *bucket, PyObject *key)
{
    int has = PyDict_Contains(bucket, key);
    if (has < 0)
        return -1;
    if (has && PyDict_DelItem(bucket, key) < 0)
        return -1;
    return 0;
}

/* commit_apply(stamped, objects, by_node, reindex_cb) -> None
 *
 * Install each stamped task into the objects table; maintain the by_node
 * index for the common case (only node_id changed).  reindex_cb(old, new)
 * handles the rare service/slot change. */
static PyObject *
commit_apply(PyObject *self, PyObject *args)
{
    PyObject *stamped, *objects, *by_node, *reindex_cb;
    if (!PyArg_ParseTuple(args, "OOOO", &stamped, &objects, &by_node,
                          &reindex_cb))
        return NULL;
    Py_ssize_t n = PyList_GET_SIZE(stamped);
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *obj = PyList_GET_ITEM(stamped, i);
        PyObject *d = PyObject_GetAttr(obj, s_dict);
        if (!d)
            return NULL;
        PyObject *tid = PyDict_GetItem(d, s_id);
        if (!tid) {
            PyErr_SetString(PyExc_KeyError, "stamped task has no id");
            Py_DECREF(d);
            return NULL;
        }
        PyObject *old = PyDict_GetItem(objects, tid); /* borrowed */
        Py_XINCREF(old);
        if (PyDict_SetItem(objects, tid, obj) < 0) {
            Py_XDECREF(old);
            Py_DECREF(d);
            return NULL;
        }
        if (old) {
            PyObject *od = PyObject_GetAttr(old, s_dict);
            if (!od) {
                Py_DECREF(old);
                Py_DECREF(d);
                return NULL;
            }
            PyObject *osid = PyDict_GetItem(od, s_service_id);
            PyObject *nsid = PyDict_GetItem(d, s_service_id);
            PyObject *oslot = PyDict_GetItem(od, s_slot);
            PyObject *nslot = PyDict_GetItem(d, s_slot);
            int same_sid = dict_vals_equal(osid, nsid);
            int same_slot = same_sid < 0 ? 0
                            : dict_vals_equal(oslot, nslot);
            if (same_sid < 0 || same_slot < 0) {
                Py_DECREF(od);
                Py_DECREF(old);
                Py_DECREF(d);
                return NULL;
            }
            if (!same_sid || !same_slot) {
                PyObject *r = PyObject_CallFunctionObjArgs(reindex_cb, old,
                                                           obj, NULL);
                if (!r) {
                    Py_DECREF(od);
                    Py_DECREF(old);
                    Py_DECREF(d);
                    return NULL;
                }
                Py_DECREF(r);
            }
            else {
                PyObject *onid = PyDict_GetItem(od, s_node_id);
                PyObject *nnid = PyDict_GetItem(d, s_node_id);
                int eq = dict_vals_equal(onid, nnid);
                if (eq < 0) {
                    Py_DECREF(od);
                    Py_DECREF(old);
                    Py_DECREF(d);
                    return NULL;
                }
                if (!eq) {
                    if (onid && PyObject_IsTrue(onid)) {
                        PyObject *st = PyDict_GetItem(by_node, onid);
                        if (st && bucket_discard(st, tid) < 0) {
                            Py_DECREF(od);
                            Py_DECREF(old);
                            Py_DECREF(d);
                            return NULL;
                        }
                    }
                    if (nnid && PyObject_IsTrue(nnid)) {
                        PyObject *st = PyDict_GetItem(by_node, nnid);
                        if (!st) {
                            PyObject *ns = PyDict_New();
                            if (!ns ||
                                PyDict_SetItem(by_node, nnid, ns) < 0) {
                                Py_XDECREF(ns);
                                Py_DECREF(od);
                                Py_DECREF(old);
                                Py_DECREF(d);
                                return NULL;
                            }
                            Py_DECREF(ns);
                            st = PyDict_GetItem(by_node, nnid);
                        }
                        if (PyDict_SetItem(st, tid, Py_None) < 0) {
                            Py_DECREF(od);
                            Py_DECREF(old);
                            Py_DECREF(d);
                            return NULL;
                        }
                    }
                }
            }
            Py_DECREF(od);
            Py_DECREF(old);
        }
        Py_DECREF(d);
    }
    Py_RETURN_NONE;
}

/* block_commit(old_tasks, node_ids, objects, overlay, by_node,
 *              ts, state, message, start_seq, guard_state)
 *   -> (committed, slow, new_seq)
 *
 * Fast path of MemoryStore.commit_task_block: items whose mirror object
 * IS the stored object (pointer identity), with no pending overlay entry
 * and a stored state below guard_state, commit by writing an overlay
 * tuple (node_id, version, ts, state, message) and maintaining the
 * by_node index.  Everything else lands in `slow` (list of indices) for
 * the Python caller's full-semantics loop.  No Task objects are built.
 */
static PyObject *
block_commit(PyObject *self, PyObject *args)
{
    PyObject *old_tasks, *node_ids, *objects, *overlay, *by_node;
    PyObject *ts, *state, *message, *guard_state;
    long long seq;
    if (!PyArg_ParseTuple(args, "O!O!O!O!O!OOOLO", &PyList_Type,
                          &old_tasks, &PyList_Type, &node_ids,
                          &PyDict_Type, &objects, &PyDict_Type, &overlay,
                          &PyDict_Type, &by_node, &ts, &state, &message,
                          &seq, &guard_state))
        return NULL;
    /* the guard is an IntEnum: convert once so the per-task check is a
     * plain C compare instead of a RichCompare through enum __ge__ */
    long long guard_ll = PyLong_AsLongLong(guard_state);
    int guard_ok = !(guard_ll == -1 && PyErr_Occurred());
    if (!guard_ok)
        PyErr_Clear();
    Py_ssize_t n = PyList_GET_SIZE(old_tasks);
    if (PyList_GET_SIZE(node_ids) != n) {
        PyErr_SetString(PyExc_ValueError, "old_tasks/node_ids mismatch");
        return NULL;
    }
    PyObject *committed = PyList_New(0);
    PyObject *slow = PyList_New(0);
    if (!committed || !slow)
        goto fail;
    /* the planner emits placements sorted by node (np.repeat over the
     * per-node counts), so consecutive items usually share a node: cache
     * the by_node set across the run instead of a dict lookup per task */
    PyObject *run_nid = NULL;  /* borrowed; element of node_ids */
    PyObject *run_set = NULL;  /* borrowed; by_node[run_nid] or NULL */
    /* committed is usually exactly range(n): track contiguity and only
     * materialize index objects once a gap appears */
    Py_ssize_t n_contig = 0;
    int contiguous = 1;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *old = PyList_GET_ITEM(old_tasks, i);
        /* instance dicts via the dict pointer: dataclass instances always
         * have one, and this skips the __dict__ descriptor machinery on
         * the hottest lookup of the loop (falls back for odd objects) */
        PyObject **dp = _PyObject_GetDictPtr(old);
        PyObject *d;
        if (dp != NULL && *dp != NULL) {
            d = *dp;
            Py_INCREF(d);   /* keep the DECREF discipline uniform */
        } else {
            d = PyObject_GetAttr(old, s_dict);
            if (!d)
                goto fail;
        }
        PyObject *tid = PyDict_GetItem(d, s_id);
        int take_slow = 0;
        if (!tid) {
            take_slow = 1;
        } else {
            PyObject *cur = PyDict_GetItem(objects, tid);
            int in_overlay = PyDict_Contains(overlay, tid);
            if (in_overlay < 0) {
                Py_DECREF(d);
                goto fail;
            }
            if (cur != old || in_overlay) {
                take_slow = 1;
            } else {
                PyObject *status = PyDict_GetItem(d, s_status);
                PyObject *st = NULL;
                if (status != NULL) {
                    PyObject **sdp = _PyObject_GetDictPtr(status);
                    if (sdp != NULL && *sdp != NULL)
                        st = PyDict_GetItem(*sdp, s_state); /* borrowed */
                }
                if (!st) {
                    take_slow = 1;
                } else if (guard_ok) {
                    long long stv = PyLong_AsLongLong(st);
                    if (stv == -1 && PyErr_Occurred()) {
                        PyErr_Clear();
                        take_slow = 1;
                    } else {
                        take_slow = stv >= guard_ll;
                    }
                } else {
                    int ge = PyObject_RichCompareBool(st, guard_state,
                                                      Py_GE);
                    if (ge < 0) {
                        Py_DECREF(d);
                        goto fail;
                    }
                    take_slow = ge;   /* guard conflict: Python decides */
                }
            }
        }
        if (take_slow) {
            PyObject *idx = PyLong_FromSsize_t(i);
            int r = idx ? PyList_Append(slow, idx) : -1;
            Py_XDECREF(idx);
            Py_DECREF(d);
            if (r < 0)
                goto fail;
            if (contiguous) {
                /* a gap: backfill 0..n_contig-1 and switch to appends */
                contiguous = 0;
                for (Py_ssize_t j = 0; j < n_contig; j++) {
                    PyObject *jo = PyLong_FromSsize_t(j);
                    int jr = jo ? PyList_Append(committed, jo) : -1;
                    Py_XDECREF(jo);
                    if (jr < 0)
                        goto fail;
                }
            }
            continue;
        }
        /* accept: overlay entry + by_node index + version */
        seq++;
        PyObject *nid = PyList_GET_ITEM(node_ids, i);
        PyObject *ver = PyLong_FromLongLong(seq);
        if (!ver) {
            Py_DECREF(d);
            goto fail;
        }
        PyObject *entry = PyTuple_Pack(5, nid, ver, ts, state, message);
        Py_DECREF(ver);
        if (!entry || PyDict_SetItem(overlay, tid, entry) < 0) {
            Py_XDECREF(entry);
            Py_DECREF(d);
            goto fail;
        }
        Py_DECREF(entry);
        PyObject *onid = PyDict_GetItem(d, s_node_id);
        if (onid && PyObject_IsTrue(onid) && onid != nid) {
            int eq = dict_vals_equal(onid, nid);
            if (eq < 0) {
                Py_DECREF(d);
                goto fail;
            }
            if (!eq) {
                PyObject *os = PyDict_GetItem(by_node, onid);
                if (os && bucket_discard(os, tid) < 0) {
                    Py_DECREF(d);
                    goto fail;
                }
            }
        }
        if (nid != run_nid) {
            run_nid = nid;
            run_set = NULL;
            if (PyObject_IsTrue(nid)) {
                run_set = PyDict_GetItem(by_node, nid);
                if (!run_set) {
                    PyObject *fresh = PyDict_New();
                    if (!fresh ||
                        PyDict_SetItem(by_node, nid, fresh) < 0) {
                        Py_XDECREF(fresh);
                        Py_DECREF(d);
                        goto fail;
                    }
                    Py_DECREF(fresh);
                    run_set = PyDict_GetItem(by_node, nid);
                }
            }
        }
        if (run_set && PyDict_SetItem(run_set, tid, Py_None) < 0) {
            Py_DECREF(d);
            goto fail;
        }
        if (contiguous) {
            /* while contiguous, every accepted item has i == n_contig:
             * the only way to skip an index is the slow branch, which
             * clears the flag and backfills */
            n_contig++;
        } else {
            PyObject *idx = PyLong_FromSsize_t(i);
            int r = idx ? PyList_Append(committed, idx) : -1;
            Py_XDECREF(idx);
            if (r < 0) {
                Py_DECREF(d);
                goto fail;
            }
        }
        Py_DECREF(d);
    }
    {
        PyObject *out;
        if (contiguous) {
            /* all items fast-committed in order: hand back range(n_contig)
             * instead of n PyLong list entries */
            PyObject *rng = PyObject_CallFunction(
                (PyObject *)&PyRange_Type, "n", n_contig);
            if (!rng)
                goto fail;
            out = Py_BuildValue("(OOL)", rng, slow, seq);
            Py_DECREF(rng);
        } else {
            out = Py_BuildValue("(OOL)", committed, slow, seq);
        }
        Py_DECREF(committed);
        Py_DECREF(slow);
        return out;
    }
fail:
    Py_XDECREF(committed);
    Py_XDECREF(slow);
    return NULL;
}

/* block_validate(old_tasks, node_ids, objects, overlay, guard_state)
 *     -> (accepted: range|list, slow: list)
 *
 * Read-only screen for the PROPOSER block path (store.py
 * _commit_task_block_proposed): an item fast-accepts when the mirror IS
 * the stored instance, is not overlaid, and its status state is below
 * the guard; everything else routes to the Python slow loop for the
 * full bulk-path checks.  No writes — the overlay/index mutation runs
 * later, inside the consensus apply callback (block_apply below). */
static PyObject *
block_validate(PyObject *self, PyObject *args)
{
    PyObject *old_tasks, *node_ids, *objects, *overlay, *guard_state;
    if (!PyArg_ParseTuple(args, "O!O!O!O!O", &PyList_Type, &old_tasks,
                          &PyList_Type, &node_ids, &PyDict_Type, &objects,
                          &PyDict_Type, &overlay, &guard_state))
        return NULL;
    long long guard_ll = PyLong_AsLongLong(guard_state);
    int guard_ok = !(guard_ll == -1 && PyErr_Occurred());
    if (!guard_ok)
        PyErr_Clear();
    Py_ssize_t n = PyList_GET_SIZE(old_tasks);
    if (PyList_GET_SIZE(node_ids) != n) {
        PyErr_SetString(PyExc_ValueError, "old_tasks/node_ids mismatch");
        return NULL;
    }
    PyObject *accepted = PyList_New(0);
    PyObject *slow = PyList_New(0);
    if (!accepted || !slow)
        goto fail;
    Py_ssize_t n_contig = 0;
    int contiguous = 1;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *old = PyList_GET_ITEM(old_tasks, i);
        PyObject **dp = _PyObject_GetDictPtr(old);
        PyObject *d = (dp != NULL && *dp != NULL) ? *dp : NULL;
        int take_slow = 0;
        PyObject *tid = d ? PyDict_GetItem(d, s_id) : NULL;
        if (!tid) {
            take_slow = 1;
        } else {
            PyObject *cur = PyDict_GetItem(objects, tid);
            int in_overlay = PyDict_Contains(overlay, tid);
            if (in_overlay < 0)
                goto fail;
            if (cur != old || in_overlay) {
                take_slow = 1;
            } else {
                PyObject *status = PyDict_GetItem(d, s_status);
                PyObject *st = NULL;
                if (status != NULL) {
                    PyObject **sdp = _PyObject_GetDictPtr(status);
                    if (sdp != NULL && *sdp != NULL)
                        st = PyDict_GetItem(*sdp, s_state);
                }
                if (!st) {
                    take_slow = 1;
                } else if (guard_ok) {
                    long long stv = PyLong_AsLongLong(st);
                    if (stv == -1 && PyErr_Occurred()) {
                        PyErr_Clear();
                        take_slow = 1;
                    } else {
                        take_slow = stv >= guard_ll;
                    }
                } else {
                    int ge = PyObject_RichCompareBool(st, guard_state,
                                                      Py_GE);
                    if (ge < 0)
                        goto fail;
                    take_slow = ge;
                }
            }
        }
        if (take_slow) {
            PyObject *idx = PyLong_FromSsize_t(i);
            int r = idx ? PyList_Append(slow, idx) : -1;
            Py_XDECREF(idx);
            if (r < 0)
                goto fail;
            if (contiguous) {
                contiguous = 0;
                for (Py_ssize_t j = 0; j < n_contig; j++) {
                    PyObject *jo = PyLong_FromSsize_t(j);
                    int jr = jo ? PyList_Append(accepted, jo) : -1;
                    Py_XDECREF(jo);
                    if (jr < 0)
                        goto fail;
                }
            }
            continue;
        }
        if (contiguous) {
            n_contig++;
        } else {
            PyObject *idx = PyLong_FromSsize_t(i);
            int r = idx ? PyList_Append(accepted, idx) : -1;
            Py_XDECREF(idx);
            if (r < 0)
                goto fail;
        }
    }
    {
        PyObject *out;
        if (contiguous) {
            PyObject *rng = PyObject_CallFunction(
                (PyObject *)&PyRange_Type, "n", n_contig);
            if (!rng)
                goto fail;
            out = Py_BuildValue("(OO)", rng, slow);
            Py_DECREF(rng);
        } else {
            out = Py_BuildValue("(OO)", accepted, slow);
        }
        Py_DECREF(accepted);
        Py_DECREF(slow);
        return out;
    }
fail:
    Py_XDECREF(accepted);
    Py_XDECREF(slow);
    return NULL;
}

/* block_apply(old_tasks, node_ids, accepted, overlay, by_node, ts,
 *             state, message, base_seq) -> end_seq
 *
 * Write phase of the proposer block path, run inside the consensus
 * apply callback: install (node_id, version, ts, state, message)
 * overlay entries and maintain the by_node index for every accepted
 * index, versions running base_seq+1.. in accepted order.  Mirrors the
 * accept branch of block_commit exactly. */
static PyObject *
block_apply(PyObject *self, PyObject *args)
{
    PyObject *old_tasks, *node_ids, *accepted;
    PyObject *overlay, *by_node, *ts, *state, *message;
    long long seq;
    if (!PyArg_ParseTuple(args, "O!O!OO!O!OOOL", &PyList_Type, &old_tasks,
                          &PyList_Type, &node_ids, &accepted,
                          &PyDict_Type, &overlay, &PyDict_Type, &by_node,
                          &ts, &state, &message, &seq))
        return NULL;
    PyObject *fast = PySequence_Fast(accepted, "accepted must be iterable");
    if (!fast)
        return NULL;
    Py_ssize_t k = PySequence_Fast_GET_SIZE(fast);
    Py_ssize_t n = PyList_GET_SIZE(old_tasks);
    PyObject *run_nid = NULL;
    PyObject *run_set = NULL;
    for (Py_ssize_t j = 0; j < k; j++) {
        PyObject *io = PySequence_Fast_GET_ITEM(fast, j);
        Py_ssize_t i = PyLong_AsSsize_t(io);
        if (i < 0 || i >= n) {
            if (PyErr_Occurred())
                goto fail;
            PyErr_SetString(PyExc_IndexError, "accepted index out of range");
            goto fail;
        }
        PyObject *old = PyList_GET_ITEM(old_tasks, i);
        PyObject **dp = _PyObject_GetDictPtr(old);
        PyObject *d = (dp != NULL && *dp != NULL) ? *dp : NULL;
        PyObject *tid = d ? PyDict_GetItem(d, s_id) : NULL;
        if (!tid) {
            PyErr_SetString(PyExc_ValueError, "task without id");
            goto fail;
        }
        seq++;
        PyObject *nid = PyList_GET_ITEM(node_ids, i);
        PyObject *ver = PyLong_FromLongLong(seq);
        if (!ver)
            goto fail;
        PyObject *entry = PyTuple_Pack(5, nid, ver, ts, state, message);
        Py_DECREF(ver);
        if (!entry || PyDict_SetItem(overlay, tid, entry) < 0) {
            Py_XDECREF(entry);
            goto fail;
        }
        Py_DECREF(entry);
        PyObject *onid = PyDict_GetItem(d, s_node_id);
        if (onid && PyObject_IsTrue(onid) && onid != nid) {
            int eq = dict_vals_equal(onid, nid);
            if (eq < 0)
                goto fail;
            if (!eq) {
                PyObject *os = PyDict_GetItem(by_node, onid);
                if (os && bucket_discard(os, tid) < 0)
                    goto fail;
            }
        }
        if (nid != run_nid) {
            run_nid = nid;
            run_set = NULL;
            if (PyObject_IsTrue(nid)) {
                run_set = PyDict_GetItem(by_node, nid);
                if (!run_set) {
                    PyObject *fresh = PyDict_New();
                    if (!fresh ||
                        PyDict_SetItem(by_node, nid, fresh) < 0) {
                        Py_XDECREF(fresh);
                        goto fail;
                    }
                    Py_DECREF(fresh);
                    run_set = PyDict_GetItem(by_node, nid);
                }
            }
        }
        if (run_set && PyDict_SetItem(run_set, tid, Py_None) < 0)
            goto fail;
    }
    Py_DECREF(fast);
    return PyLong_FromLongLong(seq);
fail:
    Py_DECREF(fast);
    return NULL;
}

/* ------------------------------------------------------------------ *
 * Columnar commit plane (ISSUE 13): binary block entries, follower    *
 * apply, and native watch fan-out.                                   *
 * ------------------------------------------------------------------ */

/* Little-endian readers over an untrusted byte buffer.  The container
 * targets x86_64; plain memcpy reads are both alignment-safe and
 * little-endian there (serde.block_to_bytes writes `<` struct codes). */
static uint32_t
rd_u32(const char *p)
{
    uint32_t v;
    memcpy(&v, p, 4);
    return v;
}

static int64_t
rd_i64(const char *p)
{
    int64_t v;
    memcpy(&v, p, 8);
    return v;
}

static int32_t
rd_i32(const char *p)
{
    int32_t v;
    memcpy(&v, p, 4);
    return v;
}

static double
rd_f64(const char *p)
{
    double v;
    memcpy(&v, p, 8);
    return v;
}

/* Split a NUL-joined blob of `count` strings into a fresh tuple.  The
 * offset scan runs with the GIL released (pure byte work); the string
 * objects are built afterwards under the GIL. */
static PyObject *
split_nul_blob(const char *blob, Py_ssize_t len, Py_ssize_t count)
{
    if (count == 0) {
        if (len != 0) {
            PyErr_SetString(PyExc_ValueError, "block: dangling blob");
            return NULL;
        }
        return PyTuple_New(0);
    }
    Py_ssize_t *offs = PyMem_Malloc((count + 1) * sizeof(Py_ssize_t));
    if (!offs)
        return PyErr_NoMemory();
    Py_ssize_t found = 0;
    int ok = 1;
    Py_BEGIN_ALLOW_THREADS
    offs[0] = 0;
    found = 1;
    const char *p = blob;
    const char *end = blob + len;
    for (; p < end && found < count;) {
        const char *nul = memchr(p, '\0', end - p);
        if (nul == NULL)
            break;
        offs[found++] = (nul - blob) + 1;
        p = nul + 1;
    }
    offs[count] = len + 1;  /* sentinel: final string ends at len */
    if (found != count)
        ok = 0;
    else if (memchr(p, '\0', end - p) != NULL)
        /* extra separators beyond count-1: the Python oracle's split()
         * would yield more strings and raise — match it exactly */
        ok = 0;
    Py_END_ALLOW_THREADS
    if (!ok) {
        PyMem_Free(offs);
        PyErr_SetString(PyExc_ValueError, "block: string count mismatch");
        return NULL;
    }
    PyObject *out = PyTuple_New(count);
    if (!out) {
        PyMem_Free(offs);
        return NULL;
    }
    for (Py_ssize_t i = 0; i < count; i++) {
        Py_ssize_t start = offs[i];
        Py_ssize_t stop = offs[i + 1] - 1;  /* drop the separator */
        PyObject *s = PyUnicode_DecodeUTF8(blob + start, stop - start,
                                           "strict");
        if (!s) {
            PyMem_Free(offs);
            Py_DECREF(out);
            return NULL;
        }
        PyTuple_SET_ITEM(out, i, s);
    }
    PyMem_Free(offs);
    return out;
}

/* block_decode(data: bytes, taskblock_cls) -> TaskBlockAction
 *
 * Parse the compact binary task-block raft entry (layout documented in
 * state/serde.py block_to_bytes, magic "SKB1") straight into a
 * TaskBlockAction — no JSON dicts, no per-item Python loop on the
 * caller's side.  The differential oracle is serde.block_from_bytes. */
static PyObject *
block_decode(PyObject *self, PyObject *args)
{
    Py_buffer buf;
    PyObject *cls;
    if (!PyArg_ParseTuple(args, "y*O", &buf, &cls))
        return NULL;
    const char *p = buf.buf;
    Py_ssize_t len = buf.len;
    PyObject *ids = NULL, *msg = NULL, *nids = NULL, *out = NULL;
    PyObject *runs = NULL;
#define NEED(nbytes)                                                          \
    do {                                                                      \
        if (len - off < (Py_ssize_t)(nbytes)) {                               \
            PyErr_SetString(PyExc_ValueError, "block: truncated entry");      \
            goto done;                                                        \
        }                                                                     \
    } while (0)
    Py_ssize_t off = 0;
    NEED(32);
    if (memcmp(p, "SKB1", 4) != 0) {
        PyErr_SetString(PyExc_ValueError, "block: bad magic");
        goto done;
    }
    uint32_t n = rd_u32(p + 4);
    int64_t base = rd_i64(p + 8);
    int32_t state = rd_i32(p + 16);
    double ts = rd_f64(p + 20);
    uint32_t msg_len = rd_u32(p + 28);
    off = 32;
    NEED(msg_len);
    msg = PyUnicode_DecodeUTF8(p + off, msg_len, "strict");
    if (!msg)
        goto done;
    off += msg_len;
    NEED(4);
    uint32_t ids_len = rd_u32(p + off);
    off += 4;
    NEED(ids_len);
    ids = split_nul_blob(p + off, ids_len, n);
    if (!ids)
        goto done;
    off += ids_len;
    NEED(4);
    uint32_t n_runs = rd_u32(p + off);
    off += 4;
    NEED((size_t)n_runs * 4 + 4);
    const char *counts = p + off;
    off += (Py_ssize_t)n_runs * 4;
    uint32_t nid_len = rd_u32(p + off);
    off += 4;
    NEED(nid_len);
    runs = split_nul_blob(p + off, nid_len, n_runs);
    if (!runs)
        goto done;
    off += nid_len;
    if (off != len) {
        PyErr_SetString(PyExc_ValueError, "block: trailing bytes");
        goto done;
    }
    /* expand the node-id runs into the full n-length column */
    nids = PyTuple_New(n);
    if (!nids)
        goto done;
    {
        Py_ssize_t k = 0;
        for (uint32_t r = 0; r < n_runs; r++) {
            uint32_t cnt = rd_u32(counts + (size_t)r * 4);
            PyObject *nid = PyTuple_GET_ITEM(runs, r);
            for (uint32_t c = 0; c < cnt; c++) {
                if (k >= (Py_ssize_t)n) {
                    PyErr_SetString(PyExc_ValueError,
                                    "block: run counts exceed n");
                    goto done;
                }
                Py_INCREF(nid);
                PyTuple_SET_ITEM(nids, k++, nid);
            }
        }
        if (k != (Py_ssize_t)n) {
            PyErr_SetString(PyExc_ValueError,
                            "block: run counts short of n");
            goto done;
        }
    }
    {
        PyObject *base_obj = PyLong_FromLongLong(base);
        PyObject *state_obj = PyLong_FromLong(state);
        PyObject *ts_obj = PyFloat_FromDouble(ts);
        if (base_obj && state_obj && ts_obj)
            out = PyObject_CallFunctionObjArgs(
                cls, s_task_block, ids, nids, base_obj, state_obj, msg,
                ts_obj, NULL);
        Py_XDECREF(base_obj);
        Py_XDECREF(state_obj);
        Py_XDECREF(ts_obj);
    }
done:
    Py_XDECREF(ids);
    Py_XDECREF(msg);
    Py_XDECREF(nids);
    Py_XDECREF(runs);
    PyBuffer_Release(&buf);
    return out;
#undef NEED
}

/* block_apply_follower(ids, node_ids, objects, overlay, by_node, ts,
 *                      state, message, base_version) -> olds list | None
 *
 * Follower-side fast path of MemoryStore._apply_task_block_locked: when
 * EVERY id resolves to a stored object and none has a pending overlay
 * entry (the healthy-log case), install the overlay tuples and maintain
 * the by_node index in ONE batched pass per chunk (run-cached bucket,
 * insertion order preserved) and return the pre-assignment stored tasks
 * in block order.  Any miss returns None untouched — the Python loop
 * then runs the full per-item semantics (materialization, skipped-id
 * contiguity handling). */
static PyObject *
block_apply_follower(PyObject *self, PyObject *args)
{
    PyObject *ids, *node_ids, *objects, *overlay, *by_node;
    PyObject *ts, *state, *message;
    long long base;
    if (!PyArg_ParseTuple(args, "OOO!O!O!OOOL", &ids, &node_ids,
                          &PyDict_Type, &objects, &PyDict_Type, &overlay,
                          &PyDict_Type, &by_node, &ts, &state, &message,
                          &base))
        return NULL;
    PyObject *ids_f = PySequence_Fast(ids, "ids must be a sequence");
    if (!ids_f)
        return NULL;
    PyObject *nids_f = PySequence_Fast(node_ids,
                                       "node_ids must be a sequence");
    if (!nids_f) {
        Py_DECREF(ids_f);
        return NULL;
    }
    Py_ssize_t n = PySequence_Fast_GET_SIZE(ids_f);
    PyObject *olds = NULL;
    if (PySequence_Fast_GET_SIZE(nids_f) != n) {
        PyErr_SetString(PyExc_ValueError, "ids/node_ids mismatch");
        goto fail;
    }
    /* screen: every id stored, none overlaid — else the Python slow
     * path owns the whole block (mixed fast/slow would reorder the
     * version assignment the changelog contract pins) */
    olds = PyList_New(n);
    if (!olds)
        goto fail;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *tid = PySequence_Fast_GET_ITEM(ids_f, i);
        PyObject *cur = PyDict_GetItemWithError(objects, tid);
        if (!cur) {
            if (PyErr_Occurred())
                goto fail;
            Py_DECREF(olds);
            Py_DECREF(ids_f);
            Py_DECREF(nids_f);
            Py_RETURN_NONE;
        }
        int in_overlay = PyDict_Contains(overlay, tid);
        if (in_overlay < 0)
            goto fail;
        if (in_overlay) {
            Py_DECREF(olds);
            Py_DECREF(ids_f);
            Py_DECREF(nids_f);
            Py_RETURN_NONE;
        }
        Py_INCREF(cur);
        PyList_SET_ITEM(olds, i, cur);
    }
    /* apply: overlay entries + one batched by_node pass (run-cached) */
    {
        PyObject *run_nid = NULL;
        PyObject *run_set = NULL;
        long long seq = base;
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *tid = PySequence_Fast_GET_ITEM(ids_f, i);
            PyObject *nid = PySequence_Fast_GET_ITEM(nids_f, i);
            seq++;
            PyObject *ver = PyLong_FromLongLong(seq);
            if (!ver)
                goto fail;
            PyObject *entry = PyTuple_Pack(5, nid, ver, ts, state,
                                           message);
            Py_DECREF(ver);
            if (!entry || PyDict_SetItem(overlay, tid, entry) < 0) {
                Py_XDECREF(entry);
                goto fail;
            }
            Py_DECREF(entry);
            PyObject *cur = PyList_GET_ITEM(olds, i);
            PyObject **cdp = _PyObject_GetDictPtr(cur);
            PyObject *onid = (cdp && *cdp)
                ? PyDict_GetItem(*cdp, s_node_id) : NULL;
            if (onid && PyObject_IsTrue(onid) && onid != nid) {
                int eq = dict_vals_equal(onid, nid);
                if (eq < 0)
                    goto fail;
                if (!eq) {
                    PyObject *os = PyDict_GetItem(by_node, onid);
                    if (os && bucket_discard(os, tid) < 0)
                        goto fail;
                }
            }
            if (nid != run_nid) {
                run_nid = nid;
                run_set = NULL;
                if (PyObject_IsTrue(nid)) {
                    run_set = PyDict_GetItem(by_node, nid);
                    if (!run_set) {
                        PyObject *fresh = PyDict_New();
                        if (!fresh ||
                            PyDict_SetItem(by_node, nid, fresh) < 0) {
                            Py_XDECREF(fresh);
                            goto fail;
                        }
                        Py_DECREF(fresh);
                        run_set = PyDict_GetItem(by_node, nid);
                    }
                }
            }
            if (run_set && PyDict_SetItem(run_set, tid, Py_None) < 0)
                goto fail;
        }
    }
    Py_DECREF(ids_f);
    Py_DECREF(nids_f);
    return olds;
fail:
    Py_XDECREF(olds);
    Py_DECREF(ids_f);
    Py_DECREF(nids_f);
    return NULL;
}

/* fanout_expand(olds, node_ids, base_version, ts, status, event_cls)
 *   -> list[Event]
 *
 * Synthesize the per-task update Events of one EventTaskBlock in a
 * single native pass: clone each pre-assignment task (Task.copy
 * semantics — shared spec, isolated meta/status/list containers), stamp
 * node_id / the shared assigned status / version base+1+i /
 * updated_at=ts, and wrap it in event_cls("update", new, old).  The
 * pure-Python oracle is EventTaskBlock.expand_events; `status` is the
 * TaskStatus every materialized task shares (same value the oracle
 * builds per task — plan_apply's shared-status precedent). */
static PyObject *
fanout_expand(PyObject *self, PyObject *args)
{
    PyObject *olds, *node_ids, *ts, *status, *event_cls;
    long long base;
    if (!PyArg_ParseTuple(args, "OOLOOO", &olds, &node_ids, &base, &ts,
                          &status, &event_cls))
        return NULL;
    PyObject *olds_f = PySequence_Fast(olds, "olds must be a sequence");
    if (!olds_f)
        return NULL;
    PyObject *nids_f = PySequence_Fast(node_ids,
                                       "node_ids must be a sequence");
    if (!nids_f) {
        Py_DECREF(olds_f);
        return NULL;
    }
    Py_ssize_t n = PySequence_Fast_GET_SIZE(olds_f);
    PyObject *out = NULL;
    if (PySequence_Fast_GET_SIZE(nids_f) != n) {
        PyErr_SetString(PyExc_ValueError, "olds/node_ids mismatch");
        goto fail;
    }
    out = PyList_New(n);
    if (!out)
        goto fail;
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *old = PySequence_Fast_GET_ITEM(olds_f, i);
        PyObject *nid = PySequence_Fast_GET_ITEM(nids_f, i);
        PyObject *d = NULL;
        PyObject *nt = shallow_clone(old, &d);
        if (!nt)
            goto fail;
        PyObject *meta = PyDict_GetItem(d, s_meta);
        PyObject *nm = NULL;
        if (meta) {
            nm = clone_meta(meta);
            if (!nm || PyDict_SetItem(d, s_meta, nm) < 0)
                goto item_fail;
        }
        if (PyDict_SetItem(d, s_status, status) < 0 ||
            PyDict_SetItem(d, s_node_id, nid) < 0 ||
            copy_list_field(d, s_networks) < 0 ||
            copy_list_field(d, s_volumes) < 0 ||
            copy_list_field(d, s_agr) < 0)
            goto item_fail;
        if (nm) {
            PyObject *nv = PyObject_GetAttr(nm, s_version);
            PyObject *ver = PyLong_FromLongLong(base + 1 + i);
            int err = !nv || !ver ||
                      PyObject_SetAttr(nv, s_index, ver) < 0 ||
                      PyObject_SetAttr(nm, s_updated_at, ts) < 0;
            Py_XDECREF(nv);
            Py_XDECREF(ver);
            if (err)
                goto item_fail;
        }
        {
            PyObject *ev = PyObject_CallFunctionObjArgs(
                event_cls, s_update, nt, old, NULL);
            if (!ev)
                goto item_fail;
            PyList_SET_ITEM(out, i, ev);
        }
        Py_XDECREF(nm);
        Py_DECREF(d);
        Py_DECREF(nt);
        continue;
    item_fail:
        Py_XDECREF(nm);
        Py_XDECREF(d);
        Py_DECREF(nt);
        goto fail;
    }
    Py_DECREF(olds_f);
    Py_DECREF(nids_f);
    return out;
fail:
    Py_XDECREF(out);
    Py_DECREF(olds_f);
    Py_DECREF(nids_f);
    return NULL;
}

/* fanout_filter(events, predicate) -> list
 *
 * Per-subscriber predicate pre-filter over an expanded event list: one
 * tight native loop instead of a Python-level comprehension per
 * subscriber.  A predicate exception drops only the offending event —
 * the same granularity as Subscription._expand's Python fallback. */
static PyObject *
fanout_filter(PyObject *self, PyObject *args)
{
    PyObject *events, *pred;
    if (!PyArg_ParseTuple(args, "OO", &events, &pred))
        return NULL;
    PyObject *events_f = PySequence_Fast(events,
                                         "events must be a sequence");
    if (!events_f)
        return NULL;
    Py_ssize_t n = PySequence_Fast_GET_SIZE(events_f);
    PyObject *out = PyList_New(0);
    if (!out) {
        Py_DECREF(events_f);
        return NULL;
    }
    for (Py_ssize_t i = 0; i < n; i++) {
        PyObject *ev = PySequence_Fast_GET_ITEM(events_f, i);
        PyObject *r = PyObject_CallOneArg(pred, ev);
        if (!r) {
            /* drop the offending event only — but, like the oracle's
             * `except Exception`, let KeyboardInterrupt/SystemExit/
             * MemoryError unwind instead of eating them */
            if (!PyErr_ExceptionMatches(PyExc_Exception)) {
                Py_DECREF(out);
                Py_DECREF(events_f);
                return NULL;
            }
            PyErr_Clear();
            continue;
        }
        int keep = PyObject_IsTrue(r);
        Py_DECREF(r);
        if (keep < 0) {
            if (!PyErr_ExceptionMatches(PyExc_Exception)) {
                Py_DECREF(out);
                Py_DECREF(events_f);
                return NULL;
            }
            PyErr_Clear();   /* truthiness raised: drop the event */
            keep = 0;
        }
        if (keep && PyList_Append(out, ev) < 0) {
            Py_DECREF(out);
            Py_DECREF(events_f);
            return NULL;
        }
    }
    Py_DECREF(events_f);
    return out;
}

/* per_node_group(olds, node_ids, base_version) -> dict
 *
 * node_id -> [(old_task, version), ...] grouping of one block (the
 * dispatcher sessions' O(1) membership probe), built in one native
 * pass with a run-cached bucket.  Oracle: EventTaskBlock.per_node. */
static PyObject *
per_node_group(PyObject *self, PyObject *args)
{
    PyObject *olds, *node_ids;
    long long base;
    if (!PyArg_ParseTuple(args, "OOL", &olds, &node_ids, &base))
        return NULL;
    PyObject *olds_f = PySequence_Fast(olds, "olds must be a sequence");
    if (!olds_f)
        return NULL;
    PyObject *nids_f = PySequence_Fast(node_ids,
                                       "node_ids must be a sequence");
    if (!nids_f) {
        Py_DECREF(olds_f);
        return NULL;
    }
    Py_ssize_t n = PySequence_Fast_GET_SIZE(olds_f);
    PyObject *out = NULL;
    if (PySequence_Fast_GET_SIZE(nids_f) != n) {
        PyErr_SetString(PyExc_ValueError, "olds/node_ids mismatch");
        goto fail;
    }
    out = PyDict_New();
    if (!out)
        goto fail;
    {
        PyObject *run_nid = NULL;
        PyObject *run_lst = NULL;   /* borrowed */
        for (Py_ssize_t i = 0; i < n; i++) {
            PyObject *nid = PySequence_Fast_GET_ITEM(nids_f, i);
            if (nid != run_nid || run_lst == NULL) {
                run_nid = nid;
                run_lst = PyDict_GetItemWithError(out, nid);
                if (!run_lst) {
                    if (PyErr_Occurred())
                        goto fail;
                    PyObject *fresh = PyList_New(0);
                    if (!fresh ||
                        PyDict_SetItem(out, nid, fresh) < 0) {
                        Py_XDECREF(fresh);
                        goto fail;
                    }
                    Py_DECREF(fresh);
                    run_lst = PyDict_GetItem(out, nid);
                }
            }
            PyObject *ver = PyLong_FromLongLong(base + 1 + i);
            if (!ver)
                goto fail;
            PyObject *pair = PyTuple_Pack(
                2, PySequence_Fast_GET_ITEM(olds_f, i), ver);
            Py_DECREF(ver);
            if (!pair || PyList_Append(run_lst, pair) < 0) {
                Py_XDECREF(pair);
                goto fail;
            }
            Py_DECREF(pair);
        }
    }
    Py_DECREF(olds_f);
    Py_DECREF(nids_f);
    return out;
fail:
    Py_XDECREF(out);
    Py_DECREF(olds_f);
    Py_DECREF(nids_f);
    return NULL;
}

static PyMethodDef methods[] = {
    {"plan_apply", plan_apply, METH_VARARGS,
     "Clone and register planner decisions."},
    {"block_commit", block_commit, METH_VARARGS,
     "Columnar task-block commit fast path (overlay + by_node index)."},
    {"block_stage", block_stage, METH_VARARGS,
     "Columnar staging of planned placements for the block-commit path."},
    {"block_validate", block_validate, METH_VARARGS,
     "Read-only screen for the proposer block-commit path."},
    {"block_apply", block_apply, METH_VARARGS,
     "Apply accepted block items (overlay + by_node), proposer path."},
    {"commit_prepare", commit_prepare, METH_VARARGS,
     "Validate, version-check, and stamp one commit chunk."},
    {"commit_apply", commit_apply, METH_VARARGS,
     "Install stamped tasks into the store table and indexes."},
    {"block_decode", block_decode, METH_VARARGS,
     "Parse a binary columnar task-block raft entry (GIL-released scan)."},
    {"block_apply_follower", block_apply_follower, METH_VARARGS,
     "Follower-side block apply: overlay + batched by_node index pass."},
    {"fanout_expand", fanout_expand, METH_VARARGS,
     "Synthesize the per-task watch Events of one EventTaskBlock."},
    {"fanout_filter", fanout_filter, METH_VARARGS,
     "Per-subscriber predicate pre-filter over an expanded event list."},
    {"per_node_group", per_node_group, METH_VARARGS,
     "node_id -> [(old, version)] grouping of one block."},
    {NULL, NULL, 0, NULL}};

static struct PyModuleDef moduledef = {PyModuleDef_HEAD_INIT, "_hotpath",
                                       NULL, -1, methods};

PyMODINIT_FUNC
PyInit__hotpath(void)
{
#define INTERN(var, str)                                                      \
    do {                                                                      \
        var = PyUnicode_InternFromString(str);                                \
        if (!var)                                                             \
            return NULL;                                                      \
    } while (0)
    INTERN(s_dict, "__dict__");
    INTERN(s_meta, "meta");
    INTERN(s_version, "version");
    INTERN(s_index, "index");
    INTERN(s_created_at, "created_at");
    INTERN(s_updated_at, "updated_at");
    INTERN(s_status, "status");
    INTERN(s_node_id, "node_id");
    INTERN(s_networks, "networks");
    INTERN(s_volumes, "volumes");
    INTERN(s_agr, "assigned_generic_resources");
    INTERN(s_id, "id");
    INTERN(s_state, "state");
    INTERN(s_message, "message");
    INTERN(s_err, "err");
    INTERN(s_service_id, "service_id");
    INTERN(s_slot, "slot");
    INTERN(s_old, "old");
    INTERN(s_new, "new");
    INTERN(s_update, "update");
    INTERN(s_task_block, "task_block");
#undef INTERN
    empty_tuple = PyTuple_New(0);
    if (!empty_tuple)
        return NULL;
    return PyModule_Create(&moduledef);
}
