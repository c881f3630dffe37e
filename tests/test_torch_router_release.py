"""A session orphaned while one of its acts is in flight (ROADMAP C7).

The scenario, on in-process stub replicas and no sleeps for timing:

1. a session is placed on replica 1 and acts once;
2. its next act is held inside replica 1's stub (an event it waits on);
3. the router orphans the session's replica under it: the canary rollback
   (`demote_canary`), the scale-down drain (`deplace`), the reclaim
   (`remove_replica`) or a death (`set_state(DEAD)`);
4. the held act is let go and replica 1 answers it with 200 from the old
   window;
5. the session posts `/release` (or acts once more, then releases).

The port's router leaves the orphan mark in place for such a stale reply
and does not flag it `restarted`, so the `/release` answers 200 and the
next act re-homes with `restarted: true`. The JAX router pops the mark on
the stale reply and flags it `restarted`, so the same `/release` answers
404 "unknown session": the companion test records that difference (it
is written down in ROADMAP, "Differences by design") and passes on it.
"""

import threading

import pytest

from rt1_tpu.serve import router as jrouter
from rt1_tpu.serve import stub as jstub
from rt1_tpu_torch.serve import router as prouter
from rt1_tpu_torch.serve import stub as pstub

SESSION = "c7-session"
HOLD_TIMEOUT_S = 30.0
ORPHANINGS = ("demote_canary", "deplace", "remove_replica", "dead")


def _held_app(stub_module, replica_id):
    """A stub replica whose act on SESSION can be held: with `armed` set,
    the next such act sets `entered` and waits for `proceed`."""

    class HeldStub(stub_module.StubReplicaApp):
        def __init__(self):
            super().__init__(replica_id=replica_id)
            self.armed = False
            self.entered = threading.Event()
            self.proceed = threading.Event()

        def act(self, payload, headers=None):
            if self.armed and payload.get("session_id") == SESSION:
                self.armed = False
                self.entered.set()
                if not self.proceed.wait(HOLD_TIMEOUT_S):
                    raise AssertionError("the held act was never let go")
            return super().act(payload, headers)

    return HeldStub()


class _Fleet:
    """Two in-process stub replicas behind a Router of `router_module`,
    replica 1 the canary at weight 1 (so SESSION lands there)."""

    def __init__(self, router_module, stub_module):
        self.router_module = router_module
        self.apps, self.servers, self.threads = [], [], []
        self.router = router_module.Router(replica_timeout_s=HOLD_TIMEOUT_S + 10)
        for rid in (0, 1):
            app = _held_app(stub_module, rid)
            server = stub_module.make_stub_server(app)
            thread = threading.Thread(target=server.serve_forever, daemon=True)
            thread.start()
            self.apps.append(app)
            self.servers.append(server)
            self.threads.append(thread)
            replica = router_module.Replica(rid, f"http://127.0.0.1:{server.server_address[1]}")
            replica.state = router_module.READY
            self.router.add_replica(replica)
        self.router.set_canary(1, 1.0)

    def act(self):
        return self.router.route_act({"session_id": SESSION, "image": [[[0, 0, 0]]]})

    def orphan(self, how):
        if how == "demote_canary":
            assert self.router.demote_canary() == 1
        elif how == "deplace":
            self.router.deplace(1)
        elif how == "remove_replica":
            assert self.router.remove_replica(1) is not None
        else:
            self.router.set_state(1, self.router_module.DEAD)

    def stale_act(self, how):
        """Steps 2-4: an act held at replica 1 while `how` orphans the
        session; returns its (status, body)."""
        held = self.apps[1]
        held.armed = True
        result = {}
        worker = threading.Thread(target=lambda: result.update(reply=self.act()), daemon=True)
        worker.start()
        assert held.entered.wait(HOLD_TIMEOUT_S), "the act never reached replica 1"
        self.orphan(how)
        held.proceed.set()
        worker.join(HOLD_TIMEOUT_S)
        assert not worker.is_alive(), "the held act did not return"
        return result["reply"]

    def release(self):
        return self.router.route_session_op("/release", {"session_id": SESSION})

    def close(self):
        for app in self.apps:
            app.proceed.set()
        for server in self.servers:
            server.shutdown()
            server.server_close()
        for thread in self.threads:
            thread.join(HOLD_TIMEOUT_S)


@pytest.fixture
def fleet_of():
    fleets = []

    def make(router_module, stub_module):
        fleets.append(_Fleet(router_module, stub_module))
        return fleets[-1]

    yield make
    for fleet in fleets:
        fleet.close()


def _placed(fleet):
    status, body = fleet.act()
    assert status == 200 and body["replica_id"] == 1 and body["step_index"] == 0, body
    return body


@pytest.mark.parametrize("how", ORPHANINGS)
def test_stale_reply_keeps_the_orphan_mark_and_release_answers_200(fleet_of, how):
    fleet = fleet_of(prouter, pstub)
    _placed(fleet)
    status, stale = fleet.stale_act(how)
    code, body = fleet.release()
    assert code == 200, body
    # Replica 1 served the old window (step 1): neither a restart nor a
    # migration.
    assert status == 200 and stale["replica_id"] == 1 and stale["step_index"] == 1, stale
    assert "restarted" not in stale and "migrated" not in stale, stale
    assert fleet.router.session_view(SESSION)["orphaned"] is False


@pytest.mark.parametrize("how", ORPHANINGS)
def test_stale_reply_then_the_next_act_rehomes_restarted(fleet_of, how):
    fleet = fleet_of(prouter, pstub)
    _placed(fleet)
    fleet.stale_act(how)
    assert fleet.router.session_view(SESSION) == {
        "session_id": SESSION, "replica_id": None, "orphaned": True, "migrated": False}
    status, body = fleet.act()
    assert status == 200 and body["replica_id"] == 0 and body["restarted"] is True, body
    assert body["step_index"] == 0, body  # a fresh window on replica 0
    assert fleet.router.session_view(SESSION) == {
        "session_id": SESSION, "replica_id": 0, "orphaned": False, "migrated": False}
    status, body = fleet.release()
    assert status == 200 and body == {"ok": True}, body


@pytest.mark.parametrize("how", ("demote_canary", "deplace"))
def test_jax_router_answers_404_in_the_same_scenario(fleet_of, how):
    """The JAX router (a difference by design, not a port fault): the stale
    reply pops the orphan mark and is flagged `restarted`, and the session,
    neither mapped nor marked, is then "unknown" to `/release`."""
    fleet = fleet_of(jrouter, jstub)
    _placed(fleet)
    status, body = fleet.stale_act(how)
    assert status == 200 and body["replica_id"] == 1 and body["restarted"] is True, body
    status, body = fleet.release()
    assert status == 404 and "unknown session" in body["error"], body


def test_router_session_view_over_http():
    """`GET /fleet/session?session_id=` reads the port router's view."""
    import json
    import urllib.error
    import urllib.request

    router = prouter.Router()
    server = prouter.make_router_server(router, "127.0.0.1", 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/fleet/session"
        with urllib.request.urlopen(url + "?session_id=nobody", timeout=10) as resp:
            assert json.loads(resp.read()) == {"session_id": "nobody", "replica_id": None,
                                               "orphaned": False, "migrated": False}
        with pytest.raises(urllib.error.HTTPError) as err:
            urllib.request.urlopen(url + "?session_id=", timeout=10)
        assert err.value.code == 400
    finally:
        server.shutdown()
        server.server_close()
        thread.join(10)
