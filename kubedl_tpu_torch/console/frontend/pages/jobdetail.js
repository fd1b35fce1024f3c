// Job detail page (reference pages/JobDetail): header + per-replica
// rollup + tabs for pods, events, per-pod logs, TensorBoard link-out,
// and the raw manifest. Auto-refreshes while the job is live.
import { api, esc, params, statusCell, t, tabbed } from "../app.js";

const TERMINAL = new Set(["Succeeded", "Failed"]);
let refreshTimer = null;

export async function viewJobDetail(app) {
  if (refreshTimer) { clearTimeout(refreshTimer); refreshTimer = null; }
  const q = params();
  const kind = q.get("kind") || "", ns = q.get("ns") || "";
  const name = q.get("name") || "";
  const qs = `kind=${encodeURIComponent(kind)}` +
             `&namespace=${encodeURIComponent(ns)}` +
             `&name=${encodeURIComponent(name)}`;
  // carry the active tab AND the selected log pod across auto-refreshes:
  // re-rendering must not snap a user reading worker-2's logs back to
  // the Pods tab (or the first pod) every 5 seconds
  const activeTab = app.querySelector(
    "#detail-tabs [data-tab].active")?.dataset.tab;
  const activeLogPod = app.querySelector("#log-pod")?.value;
  const data = await api(`/job/detail?${qs}`);
  const status = (((data.job.status || {}).conditions || [])
    .filter(c => c.status === "True").map(c => c.type).pop()) || "Created";

  // live jobs re-render every 5s until a terminal condition lands or the
  // user navigates away (the timer checks the hash before re-entering).
  // A transient API failure must not kill the loop silently — catch and
  // keep ticking so the page recovers when the backend does.
  if (!TERMINAL.has(status)) {
    const hash = location.hash;
    const tick = () => {
      refreshTimer = null;
      if (location.hash !== hash) return;
      Promise.resolve(viewJobDetail(app)).catch(() => {
        refreshTimer = setTimeout(tick, 5000);
      });
    };
    refreshTimer = setTimeout(tick, 5000);
  }

  // per-replica rollup: pod counts by replica type and phase
  const byReplica = {};
  for (const p of data.pods) {
    const r = byReplica[p.replica_type] ||
      (byReplica[p.replica_type] = { total: 0 });
    r.total++;
    r[p.status] = (r[p.status] || 0) + 1;
  }

  app.innerHTML = `
    <div class="panel">
      <div class="row">
        <h2 style="margin:0">${esc(name)}</h2>
        <span class="pill">${esc(kind)}</span>
        <span class="pill">${esc(ns)}</span>
        ${statusCell(status)}
        <span style="flex:1"></span>
        ${TERMINAL.has(status) ? "" :
          `<span class="muted">${esc(t("detail.autoRefresh"))}</span>`}
        <button id="refresh" class="ghost">&#8635; refresh</button>
      </div>
      <div class="replica-summary">
        ${Object.entries(byReplica).map(([rt, r]) => `
          <span class="pill">${esc(rt)}: ${r.total}
            ${Object.entries(r).filter(([k]) => k !== "total")
              .map(([k, v]) => `&middot; ${esc(k)} ${v}`).join(" ")}
          </span>`).join("")}
      </div>
      <div id="detail-tabs"></div>
    </div>`;
  document.getElementById("refresh").onclick = () => viewJobDetail(app);

  const renderPods = el => {
    el.innerHTML = `
      <table><thead><tr><th>Name</th><th>Replica</th><th>Status</th>
        <th>Restarts</th><th>Pod IP</th><th>Host IP</th><th>Started</th>
        <th>Finished</th>
      </tr></thead><tbody>
      ${data.pods.map(p => `<tr><td>${esc(p.name)}</td>
        <td>${esc(p.replica_type)}</td><td>${statusCell(p.status)}</td>
        <td class="muted">${esc(p.restarts ?? 0)}</td>
        <td class="muted">${esc(p.pod_ip)}</td>
        <td class="muted">${esc(p.host_ip)}</td>
        <td class="muted">${esc(p.gmt_started)}</td>
        <td class="muted">${esc(p.gmt_finished)}</td></tr>`).join("")}
      </tbody></table>`;
  };

  const renderEvents = el => {
    el.innerHTML = `
      <table><thead><tr><th>Time</th><th>Type</th><th>Reason</th>
        <th>Message</th><th>Count</th></tr></thead><tbody>
      ${data.events.map(e => `<tr>
        <td class="muted">${esc(e.last_timestamp)}</td><td>${esc(e.type)}</td>
        <td>${esc(e.reason)}</td><td>${esc(e.message)}</td>
        <td class="muted">${esc(e.count)}</td></tr>`).join("")}
      </tbody></table>`;
  };

  const renderLogs = el => {
    const pods = data.pods.map(p => p.name);
    const selected = pods.includes(activeLogPod) ? activeLogPod : pods[0];
    el.innerHTML = `
      <div class="row"><select id="log-pod">
        ${pods.map(p => `<option ${p === selected ? "selected" : ""}>
          ${esc(p)}</option>`).join("")}
      </select></div>
      <pre id="log-body">select a pod</pre>`;
    const load = async () => {
      const pod = el.querySelector("#log-pod").value;
      if (!pod) { el.querySelector("#log-body").textContent = "no pods"; return; }
      const lines = await api(
        `/log/logs/${encodeURIComponent(ns)}/${encodeURIComponent(pod)}`);
      el.querySelector("#log-body").textContent =
        (lines || []).join("\n") || "(no log lines)";
    };
    el.querySelector("#log-pod").onchange = load;
    if (pods.length) load();
  };

  const renderTB = async el => {
    const tb = await api(`/tensorboard/status?namespace=` +
      `${encodeURIComponent(ns)}&name=${encodeURIComponent(name)}`);
    const link = tb.service
      ? `<a href="http://${esc(tb.service)}.${esc(ns)}.svc:6006"
           target="_blank" rel="noopener">
           http://${esc(tb.service)}.${esc(ns)}.svc:6006</a>
         <span class="muted">(cluster-internal; port-forward from
           outside)</span>`
      : "—";
    el.innerHTML = `<div class="kv">
      <span class="muted">TensorBoard pod</span>
      <span>${statusCell(tb.phase)}</span>
      <span class="muted">Service</span><span>${link}</span>
      <span class="muted">Profiles</span>
      <span class="muted">XProf traces under the job logdir
        appear in TensorBoard's Profile tab</span></div>
      <div class="row" style="margin-top:8px">
        <button id="tb-reapply" class="ghost">reapply</button>
        <span id="tb-msg" class="muted"></span></div>`;
    el.querySelector("#tb-reapply").onclick = async () => {
      const msg = el.querySelector("#tb-msg");
      try {
        await api("/tensorboard/reapply", { method: "POST",
          body: JSON.stringify({ kind, namespace: ns, name }) });
        msg.textContent = "reapplied";
      } catch (e) { msg.textContent = e.message; }
    };
  };

  const renderManifest = async el => {
    const yaml = await api(
      `/job/yaml/${encodeURIComponent(ns)}/${encodeURIComponent(name)}` +
      `?kind=${encodeURIComponent(kind)}`);
    el.innerHTML = `<pre>${esc(yaml)}</pre>`;
  };

  tabbed(document.getElementById("detail-tabs"), [
    { id: "pods", label: t("detail.pods"), render: renderPods },
    { id: "events", label: t("detail.events"), render: renderEvents },
    { id: "logs", label: t("detail.logs"), render: renderLogs },
    { id: "tensorboard", label: "TensorBoard", render: renderTB },
    { id: "manifest", label: t("detail.manifest"), render: renderManifest },
  ], activeTab);
}
