// Job list page (reference pages/Jobs): kind/status/name filters,
// statistics strip, pagination, stop/delete actions.
import { api, esc, navigate, params, route, statusCell, t } from "../app.js";

const PAGE_SIZE = 15;

export async function viewJobs(app) {
  const q = params();
  const kind = q.get("kind") || "", status = q.get("status") || "";
  const name = q.get("name") || "";
  const page = parseInt(q.get("page") || "1");
  const [kinds, data, stats] = await Promise.all([
    api("/kinds"),
    api(`/job/list?current_page=${page}&page_size=${PAGE_SIZE}` +
        (kind ? `&kind=${encodeURIComponent(kind)}` : "") +
        (status ? `&status=${encodeURIComponent(status)}` : "") +
        (name ? `&name=${encodeURIComponent(name)}` : "")),
    api("/job/statistics"),
  ]);
  app.innerHTML = `
    <div class="panel">
      <h2>${esc(t("jobs.title"))}</h2>
      <div class="row">
        <select id="kind"><option value="">${esc(t("jobs.allKinds"))}</option>
          ${kinds.map(k =>
            `<option ${k === kind ? "selected" : ""}>${esc(k)}</option>`)
            .join("")}
        </select>
        <select id="status">
          <option value="">${esc(t("jobs.allStatuses"))}</option>
          ${["Created", "Queuing", "Running", "Restarting", "Succeeded",
             "Failed", "Stopped"].map(s =>
            `<option ${s === status ? "selected" : ""}>${s}</option>`)
            .join("")}
        </select>
        <input id="name" placeholder="name filter" value="${esc(name)}">
        <span class="muted">${data.total} jobs —
          ${stats.statistics.map(s =>
            `<span class="pill">${esc(s.status)}: ${s.count}</span>`)
            .join("") || "none"}</span>
      </div>
      <table><thead><tr><th>Name</th><th>Kind</th><th>Namespace</th>
        <th>Status</th><th>Created</th><th>Finished</th><th></th></tr>
      </thead><tbody>
        ${data.jobInfos.map(j => `<tr>
          <td><a href="#/job?kind=${esc(j.kind)}&ns=${esc(j.namespace)}&name=${esc(j.name)}">${esc(j.name)}</a></td>
          <td>${esc(j.kind)}</td><td>${esc(j.namespace)}</td>
          <td>${statusCell(j.status)}</td>
          <td class="muted">${esc(j.gmt_created)}</td>
          <td class="muted">${esc(j.gmt_job_finished)}</td>
          <td class="actions">${j.is_in_etcd
            ? `<button class="danger" data-stop="${esc(j.kind)}/${esc(j.namespace)}/${esc(j.name)}">${esc(t("jobs.stop"))}</button>
               <button class="danger" data-del="${esc(j.kind)}/${esc(j.namespace)}/${esc(j.name)}">${esc(t("jobs.delete"))}</button>`
            : `<span class="muted">${esc(t("jobs.archived"))}</span>`}</td>
        </tr>`).join("")}
      </tbody></table>
      <div class="row" style="margin-top:10px">
        ${page > 1 ? `<a href="#/jobs?page=${page - 1}&kind=${encodeURIComponent(kind)}&status=${encodeURIComponent(status)}&name=${encodeURIComponent(name)}">&larr; prev</a>` : ""}
        <span class="muted">page ${page}</span>
        ${page * PAGE_SIZE < data.total ? `<a href="#/jobs?page=${page + 1}&kind=${encodeURIComponent(kind)}&status=${encodeURIComponent(status)}&name=${encodeURIComponent(name)}">next &rarr;</a>` : ""}
      </div>
    </div>`;
  const reload = () => {
    const k = document.getElementById("kind").value;
    const s = document.getElementById("status").value;
    const n = document.getElementById("name").value;
    navigate(`#/jobs?kind=${encodeURIComponent(k)}` +
             `&status=${encodeURIComponent(s)}&name=${encodeURIComponent(n)}`);
  };
  document.getElementById("kind").onchange = reload;
  document.getElementById("status").onchange = reload;
  document.getElementById("name").onkeydown = e => {
    if (e.key === "Enter") reload();
  };
  app.querySelectorAll("[data-stop]").forEach(btn => btn.onclick = async () => {
    const [k, ns, nm] = btn.dataset.stop.split("/");
    await api("/job/stop", { method: "POST",
      body: JSON.stringify({ kind: k, namespace: ns, name: nm }) });
    route();
  });
  app.querySelectorAll("[data-del]").forEach(btn => btn.onclick = async () => {
    const [k, ns, nm] = btn.dataset.del.split("/");
    await api(`/job/${encodeURIComponent(ns)}/${encodeURIComponent(nm)}` +
              `?kind=${encodeURIComponent(k)}`, { method: "DELETE" });
    route();
  });
}
