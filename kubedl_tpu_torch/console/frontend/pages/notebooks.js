// Notebooks list + create form (reference pages/Notebooks +
// NotebookCreate).
import { api, esc, route, statusCell, t } from "../app.js";

export async function viewNotebooks(app) {
  const rows = await api("/notebook/list");
  app.innerHTML = `
    <div class="panel">
      <div class="row"><h2 style="margin:0">${esc(t("notebooks.title"))}</h2>
        <span style="flex:1"></span>
        <a href="#/notebook-create">
          <button class="primary">${esc(t("notebooks.create"))}</button></a>
      </div>
      <table><thead><tr><th>Name</th><th>Namespace</th><th>Status</th>
        <th>URL</th><th>Created</th><th></th></tr></thead><tbody>
        ${rows.map(n => `<tr><td>${esc(n.name)}</td><td>${esc(n.namespace)}</td>
          <td>${statusCell(n.status)}</td>
          <td>${n.url ? `<a href="${esc(n.url)}" target="_blank">${esc(n.url)}</a>` : ""}</td>
          <td class="muted">${esc(n.gmt_created)}</td>
          <td>${n.is_in_etcd
            ? `<button class="danger" data-del="${esc(n.namespace)}/${esc(n.name)}">${esc(t("jobs.delete"))}</button>`
            : `<span class="muted">${esc(t("jobs.archived"))}</span>`}</td>
        </tr>`).join("")}
      </tbody></table>
    </div>`;
  app.querySelectorAll("[data-del]").forEach(btn => btn.onclick = async () => {
    const [ns, name] = btn.dataset.del.split("/");
    await api(`/notebook/${ns}/${name}`, { method: "DELETE" });
    route();
  });
}

export async function viewNotebookCreate(app) {
  let dataSources = {};
  try { dataSources = await api("/datasource"); } catch (e) { /* optional */ }
  app.innerHTML = `
    <div class="panel"><h2>${esc(t("notebooks.create"))}</h2>
      <div class="form-grid">
        <label>Name</label><input id="n-name" placeholder="my-notebook">
        <label>Namespace</label><input id="n-ns" value="default">
        <label>Image</label>
        <input id="n-image" value="jupyter/base-notebook:latest">
        <label>CPU</label><input id="n-cpu" placeholder="2">
        <label>Memory</label><input id="n-mem" placeholder="4Gi">
        <label>Data source</label>
        <select id="n-data"><option value="">none</option>
          ${Object.keys(dataSources).map(n => `<option>${esc(n)}</option>`)
            .join("")}</select>
      </div>
      <div class="row">
        <button class="primary" id="n-go">${esc(t("submit.create"))}</button>
        <span id="n-msg" class="muted"></span>
      </div>
    </div>`;
  document.getElementById("n-go").onclick = async () => {
    const msg = document.getElementById("n-msg");
    const name = document.getElementById("n-name").value.trim();
    if (!name) { msg.textContent = "name is required";
                 msg.className = "error"; return; }
    const limits = {};
    const cpu = document.getElementById("n-cpu").value.trim();
    const mem = document.getElementById("n-mem").value.trim();
    if (cpu) limits.cpu = cpu;
    if (mem) limits.memory = mem;
    const container = {
      name: "notebook", image: document.getElementById("n-image").value,
      ...(Object.keys(limits).length ? { resources: { limits } } : {}),
    };
    const podSpec = { containers: [container] };
    const dataName = document.getElementById("n-data").value;
    if (dataName && dataSources[dataName]) {
      const ds = dataSources[dataName];
      container.volumeMounts = [{ name: "data",
        mountPath: ds.local_path || "/data" }];
      podSpec.volumes = [{ name: "data",
        persistentVolumeClaim: { claimName: ds.pvc_name } }];
    }
    try {
      await api("/notebook/submit", { method: "POST", body: JSON.stringify({
        apiVersion: "notebook.kubedl.io/v1alpha1", kind: "Notebook",
        metadata: { name,
          namespace: document.getElementById("n-ns").value || "default" },
        spec: { template: { spec: podSpec } },
      }) });
      location.hash = "#/notebooks";
    } catch (e) { msg.textContent = e.message; msg.className = "error"; }
  };
}
