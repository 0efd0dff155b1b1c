"""Global bundle adjustment and loop closure (counterpart of
splatslam_tpu/tracking/backend.py; reference
thirdparty/glorie_slam/backend.py:19-112). Both paths build a fresh
FactorGraph over the keyframe history with proximity/loop edges."""

from __future__ import annotations

from ..utils.profiling import span
from .factor_graph import FactorGraph


class Backend:
    def __init__(self, model, video, cfg):
        self.model = model
        self.video = video
        self.oracle = cfg["tracking"].get("oracle", False)
        self.beta = cfg["tracking"]["beta"]
        bk = cfg["tracking"]["backend"]
        self.backend_thresh = bk["thresh"]
        self.backend_radius = bk["radius"]
        self.backend_nms = bk["nms"]
        self.backend_normalize = bk["normalize"]
        self.loop_window = bk["loop_window"]
        self.loop_thresh = bk["loop_thresh"]
        self.loop_radius = bk["loop_radius"]
        self.loop_nms = bk["loop_nms"]

    def ba(self, t_start, t_end, steps, graph, nms, radius, thresh,
           max_factors, t_start_loop=None, loop=False, motion_only=False,
           enable_wq=True):
        if t_start_loop is None or not loop:
            t_start_loop = t_start
        with span("lc.edges"):
            edge_num = graph.add_backend_proximity_factors(
                t_start, t_end, nms, radius, thresh, max_factors, self.beta,
                t_start_loop, loop)
        if edge_num == 0:
            graph.clear_edges()
            return 0
        graph.update_lowmem(
            t0=t_start_loop + 1,   # fix the loop start to anchor drift
            t1=t_end, itrs=2, use_inactive=False, steps=steps,
            enable_wq=enable_wq, motion_only=motion_only)
        graph.clear_edges()
        return edge_num

    def dense_ba(self, steps=6, enable_wq=True):
        """Full-history global BA (backend.py:63-83)."""
        t_start, t_end = 0, self.video.counter
        n = t_end - t_start
        max_factors = ((self.backend_radius + 2) * 2) * n
        if self.backend_normalize:
            self.video.normalize()
        graph = FactorGraph(self.video, self.model, max_factors,
                            oracle=self.oracle)
        n_edges = self.ba(t_start, t_end, steps, graph, self.backend_nms,
                          self.backend_radius, self.backend_thresh,
                          max_factors, enable_wq=enable_wq)
        self.video.set_dirty(t_start, t_end)
        self.video.update_valid_depth_mask()
        return n, n_edges

    def loop_ba(self, t_start, t_end, steps=6, motion_only=False,
                local_graph=None, enable_wq=True):
        """Loop closure with covisibility edges (backend.py:87-111)."""
        max_factors = 8 * self.loop_window
        t_start_loop = max(0, t_end - self.loop_window)
        graph = FactorGraph(self.video, self.model, max_factors,
                            oracle=self.oracle)
        if local_graph is not None:
            graph.ii = local_graph.ii.copy()
            graph.jj = local_graph.jj.copy()
            graph.age = local_graph.age.copy()
            graph.net = local_graph.net
            graph.target = local_graph.target
            graph.weight = local_graph.weight
        left = max_factors - len(graph.ii)
        fill = (t_end - t_start_loop) * (self.loop_radius + 1) * 2
        if left <= fill:
            print(f"[backend] WARNING loop_ba budget infeasible: {left} "
                  f"factors left after local graph, but the mandatory "
                  f"neighborhood fill needs ~{fill} "
                  f"(loop_window={self.loop_window}) — no loop edge can be "
                  f"selected; raise loop_window or lower frontend "
                  f"max_factors")
        n_edges = self.ba(t_start, t_end, steps, graph, self.loop_nms,
                          self.loop_radius, self.loop_thresh, left,
                          t_start_loop=t_start_loop, loop=True,
                          motion_only=motion_only, enable_wq=enable_wq)
        return t_end - t_start_loop, n_edges
