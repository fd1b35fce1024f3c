// Cluster overview (reference pages/ClusterInfo, TPU-first): slice/gang
// occupancy — which slices are gang-held, by whom, pending-gang aging —
// plus per-node chips-in-use vs allocatable, per-phase pod requests and
// the node table with TPU topology labels.
import { api, esc, t } from "../app.js";

const fmt = obj => Object.entries(obj || {})
  .map(([k, v]) => `${k}: ${v}`).join(", ") || "—";

const agoFmt = s => {
  if (s == null) return "—";
  if (s < 90) return `${Math.round(s)}s`;
  if (s < 5400) return `${Math.round(s / 60)}m`;
  return `${(s / 3600).toFixed(1)}h`;
};

const meter = (used, total) => {
  const pct = total > 0 ? Math.min(100, Math.round(100 * used / total)) : 0;
  return `<span class="meter"><span class="meter-fill" style="width:${pct}%"></span></span>
    <span class="muted">${used}/${total}</span>`;
};

export async function viewCluster(app) {
  const [total, running, pending, nodes, occ] = await Promise.all([
    api("/data/total"),
    api("/data/request/Running"),
    api("/data/request/Pending"),
    api("/data/nodeInfos"),
    api("/data/occupancy"),
  ]);
  const gangRows = occ.gangs.map(g => `<tr>
      <td>${esc(g.namespace)}/${esc(g.name)}</td>
      <td>${esc(g.job)}</td>
      <td>${g.minMember}</td>
      <td>${g.running}/${g.members}
        <span class="muted">(${g.scheduled} scheduled)</span></td>
      <td>${g.tpuChips}</td>
      <td><span class="badge ${g.phase === "Running" ? "ok" : "warn"}">
        ${esc(g.phase)}</span></td>
      <td class="muted">${agoFmt(g.pendingSeconds)}</td>
    </tr>`).join("");
  const nodeRows = occ.nodes.map(n => `<tr>
      <td>${esc(n.name)}</td>
      <td>${meter(n.tpuInUse, n.tpuAllocatable)}</td>
      <td>${n.tpuIdle}</td>
      <td class="muted">${esc(n.accelerator || "")}</td>
      <td class="muted">${esc(n.topology || "")}</td>
    </tr>`).join("");
  app.innerHTML = `
    <div class="panel"><h2>${esc(t("cluster.title"))}</h2>
      <div class="kv">
        <span class="muted">Nodes</span><span>${total.nodes}</span>
        <span class="muted">TPU chips</span>
          <span>${occ.chipsInUse} in use / ${occ.totalChips} allocatable</span>
        <span class="muted">Pending gangs</span><span>${occ.pendingGangs}</span>
        <span class="muted">Running pods</span><span>${running.pods}
          <span class="muted">(${esc(fmt(running.request))})</span></span>
        <span class="muted">Pending pods</span><span>${pending.pods}
          <span class="muted">(${esc(fmt(pending.request))})</span></span>
        <span class="muted">Allocatable</span><span class="muted">${esc(fmt(total.total))}</span>
      </div>
      <h3>Gangs (slice occupancy)</h3>
      <table><thead><tr><th>PodGroup</th><th>Job</th><th>minMember</th>
        <th>Up</th><th>TPU chips</th><th>Phase</th><th>Pending for</th>
      </tr></thead><tbody>${gangRows}</tbody></table>
      ${occ.gangs.length ? "" : `<p class="muted">no PodGroups
        (no gang-scheduled jobs are live)</p>`}
      <h3>Node TPU occupancy</h3>
      <table><thead><tr><th>Node</th><th>Chips in use</th><th>Idle</th>
        <th>TPU accelerator</th><th>TPU topology</th></tr></thead><tbody>
        ${nodeRows}
      </tbody></table>
      ${occ.nodes.length ? "" : `<p class="muted">no Node objects
        (standalone mode reports the local process only)</p>`}
      <h3>Nodes</h3>
      <table><thead><tr><th>Name</th><th>Allocatable</th>
        <th>TPU accelerator</th><th>TPU topology</th></tr></thead><tbody>
        ${nodes.map(n => `<tr><td>${esc(n.name)}</td>
          <td class="muted">${esc(fmt(n.allocatable))}</td>
          <td class="muted">${esc(n.labels["cloud.google.com/gke-tpu-accelerator"] || "")}</td>
          <td class="muted">${esc(n.labels["cloud.google.com/gke-tpu-topology"] || "")}</td>
        </tr>`).join("")}
      </tbody></table>
    </div>`;
}
