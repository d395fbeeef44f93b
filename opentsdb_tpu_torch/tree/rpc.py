"""Tree HTTP endpoints (ref: ``src/tsd/TreeRpc.java``; the JAX
package's ``tree/rpc.py``).

Routes: ``/api/tree`` (CRUD), ``/api/tree/branch``, ``/api/tree/rule``,
``/api/tree/rules``, ``/api/tree/test``, ``/api/tree/collisions``,
``/api/tree/notmatched``.
"""

from __future__ import annotations

import json

from opentsdb_tpu_torch.tree.tree import TreeRule, tree_manager


def handle_tree_request(router, request, rest):
    """Answer ``/api/tree[/<rest>]`` for ``router``'s TSDB."""
    from opentsdb_tpu_torch.tsd.http_api import (HttpError, HttpResponse,
                                                 as_int)

    mgr = tree_manager(router.tsdb)
    sub = rest[0] if rest else ""

    if sub == "":
        if request.method == "GET":
            tree_id = request.param("treeid") or request.param("tree")
            if tree_id:
                tree = mgr.get_tree(int(tree_id))
                if tree is None:
                    raise HttpError(404, "Unable to locate tree")
                return HttpResponse(200, json.dumps(tree.to_json()).encode())
            return HttpResponse(200, json.dumps(
                [t.to_json() for t in mgr.all_trees()]).encode())
        if request.method in ("POST", "PUT"):
            obj = request.json_object(default={}) if request.body else {
                k: request.param(k) for k in ("treeId", "name",
                                              "description")
                if request.has_param(k)}
            tree_id = obj.get("treeId")
            if tree_id:
                tree = mgr.get_tree(int(tree_id))
                if tree is None:
                    raise HttpError(404, "Unable to locate tree")
                tree.update(obj, overwrite=request.method == "PUT")
            else:
                if not obj.get("name"):
                    raise HttpError(400, "Missing tree name")
                tree = mgr.create_tree(obj.get("name", ""),
                                       obj.get("description", ""))
                tree.update(obj, overwrite=False)
            return HttpResponse(200, json.dumps(tree.to_json()).encode())
        if request.method == "DELETE":
            tree_id = as_int(
                request.param("treeid")
                or request.json_object(default={}).get("treeId"),
                "treeId")
            if not mgr.delete_tree(tree_id,
                                   request.flag("definition")):
                raise HttpError(404, "Unable to locate tree")
            return HttpResponse(204)
        raise HttpError(405, "Method not allowed")

    if sub == "branch":
        branch_id = request.param("branch")
        tree_id = request.param("treeid")
        if branch_id:
            branch = mgr.get_branch(branch_id)
        elif tree_id:
            branch = mgr.get_root_branch(int(tree_id))
        else:
            raise HttpError(400, "Missing branch or tree id")
        if branch is None:
            raise HttpError(404, "Unable to locate branch")
        return HttpResponse(200, json.dumps(branch.to_json()).encode())

    if sub in ("rule", "rules"):
        if request.method in ("POST", "PUT"):
            # single rule = object body, bulk /rules = array body;
            # reuse the strict array parse, accepting the single-
            # object convenience form first
            if request.body and request.body.strip().startswith(b"{"):
                objs = [request.json_object()]
            else:
                objs = request.json_array(default=[])
            if not all(isinstance(o, dict) for o in objs):
                raise HttpError(400, "Each rule must be an object")
            if sub == "rule" and not objs and request.has_param("treeid"):
                objs = [{k: request.param(k)
                         for k in ("treeid", "type", "field", "level",
                                   "order", "regex", "separator")
                         if request.has_param(k)}]
            out = []
            for obj in objs:
                # or-chain (not dict-default) so an explicit
                # treeId: null still falls through to "treeid"
                tree_id = as_int(obj.get("treeId")
                                 or obj.get("treeid"), "treeId")
                tree = mgr.get_tree(tree_id)
                if tree is None:
                    raise HttpError(404, "Unable to locate tree")
                rule = TreeRule.from_json(obj)
                tree.set_rule(rule)
                out.append(rule.to_json())
            if not out:
                raise HttpError(400, "Missing rule content")
            return HttpResponse(200, json.dumps(
                out if sub == "rules" else out[0]).encode())
        if request.method == "GET" and sub == "rule":
            tree = mgr.get_tree(int(request.param("treeid", "0")))
            if tree is None:
                raise HttpError(404, "Unable to locate tree")
            rule = tree.get_rule(int(request.param("level", "0")),
                                 int(request.param("order", "0")))
            if rule is None:
                raise HttpError(404, "Unable to locate rule")
            return HttpResponse(200, json.dumps(rule.to_json()).encode())
        if request.method == "DELETE":
            tree = mgr.get_tree(int(request.param("treeid", "0")))
            if tree is None:
                raise HttpError(404, "Unable to locate tree")
            if sub == "rules":
                tree.delete_all_rules()
                return HttpResponse(204)
            if not tree.delete_rule(int(request.param("level", "0")),
                                    int(request.param("order", "0"))):
                raise HttpError(404, "Unable to locate rule")
            return HttpResponse(204)
        raise HttpError(405, "Method not allowed")

    if sub == "test":
        tree = mgr.get_tree(int(request.param("treeid", "0")))
        if tree is None:
            raise HttpError(404, "Unable to locate tree")
        tsuids = request.params.get("tsuids", [])
        if request.body:
            tsuids = request.json_object().get("tsuids", tsuids)
        results = mgr.test_tsuids(tree, tsuids)
        return HttpResponse(200, json.dumps(results).encode())

    if sub == "collisions":
        tree = mgr.get_tree(int(request.param("treeid", "0")))
        if tree is None:
            raise HttpError(404, "Unable to locate tree")
        return HttpResponse(200, json.dumps(tree.collisions).encode())

    if sub == "notmatched":
        tree = mgr.get_tree(int(request.param("treeid", "0")))
        if tree is None:
            raise HttpError(404, "Unable to locate tree")
        return HttpResponse(200, json.dumps(tree.not_matched).encode())

    raise HttpError(404, f"Endpoint not found: /api/tree/{sub}")
